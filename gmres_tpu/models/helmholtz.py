"""2-D Helmholtz model problem (symmetric INDEFINITE).

The reference library's model problems are SPD (poisson2d.f90:4-44,
hilbert.f90) and its nonsymmetric class is covered here by
models/convection_diffusion.py. What neither exercises is the third
classic regime: SYMMETRIC INDEFINITE, the domain of MINRES
(solvers/minres.py). Discretization: −Δu − k²u with the unit 5-point
stencil, h² folded out like the reference Poisson stencil
(poisson2d.f90:23-31 center 4):

    y(i,j) = (4 − (kh)²)·x(i,j) − x(i±1,j) − x(i,j±1)

The operator is symmetric for every k and indefinite as soon as (kh)²
exceeds the smallest Laplacian eigenvalue 8·sin²(π/(2(n+1))) — the
regime where CG's (r, Ap) pivots lose positivity and GMRES ignores the
symmetry it could exploit; MINRES is the right tool.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from gmres_tpu.ops.stencil import stencil_5pt_general


def helmholtz_coefs(kh2: float, damping: float = 0.0):
    """(center, west, east, south, north) stencil coefficients for
    −Δ − (1 + i·damping)·k² at squared nondimensional wavenumber
    kh2 = (k·h)². damping > 0 models an absorbing medium (the center
    coefficient — and hence the operator — becomes complex); the
    complex path rides the SAME solvers via their conjugate-correct
    dots and Givens rotations (ops/blas.py, ops/givens.py)."""
    if damping:
        return (
            4.0 - float(kh2) * complex(1.0, float(damping)),
            -1.0, -1.0, -1.0, -1.0,
        )
    return (4.0 - float(kh2), -1.0, -1.0, -1.0, -1.0)


def helmholtz_lambda_min(nsize: int, kh2: float = 0.0) -> float:
    """Exact smallest eigenvalue of the (shifted) stencil on the
    nsize×nsize Dirichlet grid: 8·sin²(π/(2(n+1))) − kh2. Negative ⇔
    the operator is indefinite (the MINRES regime)."""
    import math

    return 8.0 * math.sin(math.pi / (2 * (nsize + 1))) ** 2 - float(kh2)


def helmholtz_apply(
    x: jnp.ndarray, kh2: float = 0.5, damping: float = 0.0
) -> jnp.ndarray:
    """y = A·x on an (N, N) grid (or flat (N²,))."""
    c = helmholtz_coefs(kh2, damping)
    if x.ndim == 1:
        n = int(round(x.shape[0] ** 0.5))
        return stencil_5pt_general(x.reshape(n, n), *c).reshape(-1)
    return stencil_5pt_general(x, *c)


def helmholtz_operator(
    nsize: int, kh2: float = 0.5, damping: float = 0.0
) -> Callable:
    c = helmholtz_coefs(kh2, damping)

    def apply_grid(x: jnp.ndarray) -> jnp.ndarray:
        return stencil_5pt_general(x, *c)

    return apply_grid


def helmholtz_matrix(
    nsize: int, kh2: float = 0.5, dtype=jnp.float64, damping: float = 0.0
) -> jnp.ndarray:
    """Dense assembly for small-n validation (C-order flattening)."""
    if damping and not jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        dtype = jnp.complex128
    c0, cw, ce, cs, cn = helmholtz_coefs(kh2, damping)
    eye = jnp.eye(nsize, dtype=dtype)
    kx = (
        c0 / 2.0 * jnp.eye(nsize, dtype=dtype)
        + cw * jnp.eye(nsize, k=-1, dtype=dtype)
        + ce * jnp.eye(nsize, k=1, dtype=dtype)
    )
    ky = (
        c0 / 2.0 * jnp.eye(nsize, dtype=dtype)
        + cs * jnp.eye(nsize, k=-1, dtype=dtype)
        + cn * jnp.eye(nsize, k=1, dtype=dtype)
    )
    return jnp.kron(eye, kx) + jnp.kron(ky, eye)


def helmholtz_split_operator(
    nsize: int, kh2: float = 0.5, damping: float = 0.0
) -> Callable:
    """SPLIT-COMPLEX Helmholtz operator: the complex field u = uʳ + i·uⁱ
    carried as a STACKED REAL array (2, N, N), for runtimes without a
    complex datapath: the complex Helmholtz class runs there through
    the real-equivalent formulation

        (A + iB)(uʳ + i·uⁱ) = b  ⇔  [A −B; B A][uʳ; uⁱ] = [bʳ; bⁱ],

    which for the damped stencil is two real stencil applications plus
    the 2×2 rotation of the center term. Spectrum {λ, λ̄} — GMRES on
    the real form converges like the complex solve (conjugate pairs
    were already present in the complex nonsymmetric spectrum) — and
    the arithmetic is plain f32/f64, so it reaches f64 tolerances no
    c64 path could. The (2, N, N) stack is an
    ordinary vector to every solver (their dots/norms are exactly the
    real and imaginary parts' joint 2-norm = the complex 2-norm).

    CPU parity oracle: ``helmholtz_operator(..., damping)`` on c128
    (tests/test_helmholtz_split.py)."""
    kh2 = float(kh2)
    alpha = float(damping)

    def apply_pair(u: jnp.ndarray) -> jnp.ndarray:
        ur, ui = u[0], u[1]
        lap_r = stencil_5pt_general(ur, 4.0, -1.0, -1.0, -1.0, -1.0)
        lap_i = stencil_5pt_general(ui, 4.0, -1.0, -1.0, -1.0, -1.0)
        # −(1 + iα)·kh2·u: re −kh2·(ur − α·ui), im −kh2·(α·ur + ui)
        out_r = lap_r - kh2 * (ur - alpha * ui)
        out_i = lap_i - kh2 * (alpha * ur + ui)
        return jnp.stack([out_r, out_i])

    return apply_pair


def complex_to_split(x: jnp.ndarray) -> jnp.ndarray:
    """(N, N) complex → (2, N, N) real stack (host/CPU-side helper for
    oracles and rhs construction)."""
    return jnp.stack([jnp.real(x), jnp.imag(x)])


def split_to_complex(u: jnp.ndarray) -> jnp.ndarray:
    return u[0] + 1j * u[1]
