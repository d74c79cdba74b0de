"""Vector (BLAS-1) operations over arbitrary pytrees.

These are the JAX analogues of the reference's OpenMP vector loops:
element-wise ``!$omp do`` loops become tree-mapped jnp expressions (XLA
fuses them), and ``!$omp do reduction(+:...)`` dot products (e.g.
src/cg.f90:118-123) become full reductions that XLA turns into one local
reduce + one ``psum`` all-reduce when the operands are sharded over a
mesh. ``batched_vdot`` exists to fuse several simultaneous reductions
into a single all-reduce, mirroring the reference's fused 2-reductions
(``reduction(+:rr,alpha)`` src/cg.f90:207, ``reduction(+:rr0,ap_r0)``
src/bicgstab.f90:123-127).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp


# Basis contractions pin Precision.HIGHEST. On the GPU an f32 dot may
# otherwise run in TF32 (about three decimal digits). These are
# memory-bound GEMVs over the Krylov basis, so TF32 buys no speed, and
# in the f32 Arnoldi of GMRES-IR it can cost orthogonality and, with
# it, restarts. f64 and complex dots are unaffected.
_PRECISION = jax.lax.Precision.HIGHEST


def row_contract(rows: jnp.ndarray, v: jnp.ndarray,
                 conj: bool = False) -> jnp.ndarray:
    """Basis contraction (R, *shape) × (*shape) → (R,): rowsᵢ·v.

    The distributed analogue of the reference's per-row OpenMP dot
    reductions (gmres_hh.f90:453-485): one local reduce + one psum
    under GSPMD."""
    r = jnp.conj(rows) if conj else rows
    axes = list(range(1, rows.ndim))
    return jnp.tensordot(r, v, axes=(axes, list(range(v.ndim))),
                         precision=_PRECISION)


def row_combine(coefs: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    """Linear combination (R, *extra) × (R, *shape) → (*extra, *shape):
    out[e] = Σᵢ coefs[i, e]·rowsᵢ (communication-free under row
    sharding; `tensordot(coefs, rows, axes=(0, 0))` semantics)."""
    return jnp.tensordot(coefs, rows, axes=(0, 0), precision=_PRECISION)


def tree_vdot(a: Any, b: Any) -> jnp.ndarray:
    """Scalar inner product Σ conj(aᵢ)·bᵢ over matching pytrees
    (``jnp.vdot`` semantics: conjugate-linear in the FIRST argument —
    a no-op that XLA elides for the real dtypes every reference path
    uses; complex operators ride the same solvers, SURVEY beyond-ref)."""
    leaves = jax.tree.leaves(
        jax.tree.map(lambda x, y: jnp.sum(jnp.conj(x) * y), a, b)
    )
    return jnp.sum(jnp.stack(leaves)) if len(leaves) > 1 else leaves[0]


def tree_norm(a: Any) -> jnp.ndarray:
    """2-norm ‖a‖₂ of a pytree (Fortran ``norm2`` analogue); real
    even for complex pytrees (conj(x)·x has exactly zero imaginary
    part, but the complex DTYPE must not leak into comparisons)."""
    return jnp.sqrt(jnp.real(tree_vdot(a, a)))


def tree_add(a: Any, b: Any) -> Any:
    return jax.tree.map(jnp.add, a, b)


def tree_sub(a: Any, b: Any) -> Any:
    return jax.tree.map(jnp.subtract, a, b)


def tree_scale(alpha: jnp.ndarray, a: Any) -> Any:
    return jax.tree.map(lambda x: alpha * x, a)


def tree_axpy(alpha: jnp.ndarray, x: Any, y: Any) -> Any:
    """y + alpha * x elementwise over pytrees."""
    return jax.tree.map(lambda xi, yi: yi + alpha * xi, x, y)


def tree_zeros_like(a: Any) -> Any:
    return jax.tree.map(jnp.zeros_like, a)


def batched_vdot(pairs: Sequence[tuple[Any, Any]]) -> jnp.ndarray:
    """Compute k dot products and return them stacked as a (k,) array.

    Stacking the partial sums before the final reduction lets XLA emit a
    single fused all-reduce for all k scalars when inputs are sharded —
    the distributed analogue of the reference's multi-variable OpenMP
    reduction clauses (src/bicgstab.f90:123-127, src/cg.f90:207-212).
    """
    return jnp.stack([tree_vdot(a, b) for a, b in pairs])
