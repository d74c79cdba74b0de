"""Masked flat-index operations on N-D arrays.

The Householder GMRES variant (Walker '84) manipulates individual
components and prefixes/suffixes of vectors *in flat ordering* — e.g.
``w(1:j)=0``, ``w(j+1) -= H(j+1,j)`` (reference src/gmres_hh.f90:487-502).
On the device, vectors stay in their natural (possibly sharded) N-D shape, so
these component operations are expressed as elementwise masks against a
C-order flat-index iota. Every op here is sharding-transparent: masks
are elementwise, and the single-element reads reduce with ``jnp.sum``
(one ``psum`` when sharded).
"""

from __future__ import annotations

import jax.numpy as jnp


def flat_iota(x: jnp.ndarray) -> jnp.ndarray:
    """C-order flat index of every element, shaped like x (int32)."""
    return jnp.arange(x.size, dtype=jnp.int32).reshape(x.shape)


def flat_get(x: jnp.ndarray, i) -> jnp.ndarray:
    """x.ravel()[i] as a reduction (sharding-safe dynamic read)."""
    return jnp.sum(jnp.where(flat_iota(x) == i, x, 0))


def flat_set(x: jnp.ndarray, i, v) -> jnp.ndarray:
    """x with x.ravel()[i] = v."""
    return jnp.where(flat_iota(x) == i, v, x)


def flat_add(x: jnp.ndarray, i, v) -> jnp.ndarray:
    """x with x.ravel()[i] += v."""
    return x + jnp.where(flat_iota(x) == i, v, jnp.zeros_like(x))


def mask_lt(x: jnp.ndarray, i) -> jnp.ndarray:
    """Zero every component with flat index >= i (keep the prefix)."""
    return jnp.where(flat_iota(x) < i, x, 0)


def mask_ge(x: jnp.ndarray, i) -> jnp.ndarray:
    """Zero every component with flat index < i (keep the suffix)."""
    return jnp.where(flat_iota(x) >= i, x, 0)


def basis_vector(i, shape, dtype) -> jnp.ndarray:
    """Canonical unit vector e_i in C-order flat indexing, shaped."""
    fidx = jnp.arange(int(jnp.prod(jnp.array(shape))), dtype=jnp.int32)
    return (fidx == i).astype(dtype).reshape(shape)
