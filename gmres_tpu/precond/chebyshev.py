"""Chebyshev polynomial preconditioner.

Reference: ``src/preconds/chebyshev.f90:8-38`` (cbpr2) — a degree-2
Chebyshev approximation of A⁻¹ from eigenvalue bounds (λ_min, λ_max):

    c = (λb − λa)/2 ; d = (λb + λa)/2
    α = 1/d ; β = (c·α/2)² ; α = 1/(d − β·d²·…)   — precisely:
    α = 1/(d − (c/(2d))²·d)  [chebyshev.f90:20-25]
    z = r/d ; z += α·(r − A·z)                    [chebyshev.f90:27-37]

i.e. one operator application per preconditioning. Reference quirk
(SURVEY §7 quirk 3): every driver passes params=(8.2, 0.2) so position 1
is read as eigen_min — the values arrive (max, min)-swapped. Harmless
because c enters only squared; we accept (lam_min, lam_max) in either
order and normalize.

Beyond parity, ``chebyshev_preconditioner(order=k)`` implements the
standard order-k Chebyshev iteration z_k ≈ A⁻¹r via the three-term
recurrence on the interval [λ_min, λ_max] — each step is one fused
stencil+axpy (no dot products, no communication beyond the operator's
own halos).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.types import LinearOperator, Preconditioner


def chebyshev_ref_scalars(lam_min: float, lam_max: float):
    """(d, α) of the reference's cbpr2 closed form
    (chebyshev.f90:20-25), bounds in either order."""
    lo, hi = sorted((float(lam_min), float(lam_max)))
    c = (hi - lo) / 2.0
    d = (hi + lo) / 2.0
    alpha = 1.0 / d
    beta = (c * alpha / 2.0) ** 2
    return d, 1.0 / (d - beta)


def chebyshev_preconditioner(
    A: LinearOperator,
    lam_min: float,
    lam_max: float,
    order: int = 2,
    reference_form: bool = True,
) -> Preconditioner:
    """Return z = M⁻¹(r) approximating A⁻¹ on spectrum [lam_min, lam_max].

    order=2 with reference_form=True reproduces cbpr2 exactly
    (chebyshev.f90:20-37). Higher orders use the classic Chebyshev
    semi-iteration recurrence.
    """
    lo, hi = sorted((float(lam_min), float(lam_max)))

    if order == 2 and reference_form:
        d, alpha = chebyshev_ref_scalars(lo, hi)

        def m_inv(r):
            z = r / d
            return z + alpha * (r - A(z))

        return m_inv

    # General order-k Chebyshev semi-iteration for A z ≈ r starting at
    # z₀ = 0 (Saad, "Iterative Methods", alg. 12.1). The ρ recurrence
    # is data-independent, so the per-step coefficients are precomputed
    # host-side and the sweep is a lax.scan — deep orders (k ≥ 64)
    # would otherwise unroll k stencils into the traced graph and blow
    # up compile time inside solver while_loops.
    theta = (hi + lo) / 2.0
    delta = (hi - lo) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    steps = []
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    import numpy as _np

    coeffs = jnp.asarray(_np.asarray(steps)) if steps else None

    def m_inv(r):
        d0 = r / theta
        z = d0
        if coeffs is None:
            return z

        def sweep(carry, cf):
            z, d0 = carry
            resid = r - A(z)
            d0 = cf[0].astype(r.dtype) * d0 \
                + cf[1].astype(r.dtype) * resid
            return (z + d0, d0), None

        (z, _), _ = jax.lax.scan(sweep, (z, d0), coeffs)
        return z

    return m_inv


def chebyshev_stencil_preconditioner(
    lam_min: float,
    lam_max: float,
    order: int = 2,
    coefs=(4.0, -1.0, -1.0, -1.0, -1.0),
    use_pallas: str = "auto",
) -> Preconditioner:
    """Chebyshev preconditioner specialized to a 5-point stencil
    operator, with the fused smoother kernel
    (ops/smoother.py:poly_stencil_smoother) as its f32 GPU route: all
    ``order`` − 1 stencil sweeps in one launch per ``order`` ≤ 9 chunk
    instead of one launch and five grid passes per sweep.

    use_pallas: "auto" (the kernel for f32 grids on a single GPU, the
    jnp recurrence otherwise — f64 included, so the outer
    true-residual applications of mixed-precision GMRES-IR stay jnp),
    "never", or "interpret" (the kernel in the Pallas interpreter, for
    CPU tests).

    Both routes apply the SAME polynomial (the order-k semi-iteration)
    so dtype/backend never changes the preconditioner being applied —
    including at order=2, where the semi-iteration differs from
    cbpr2's closed form; use ``chebyshev_preconditioner`` for exact
    cbpr2 reference parity.
    """
    from gmres_tpu.ops.smoother import (
        USE_PALLAS,
        chebyshev_k_scalars,
        kernel_mode,
        poly_stencil_smoother,
    )
    from gmres_tpu.ops.stencil import stencil_5pt_general

    lo, hi = sorted((float(lam_min), float(lam_max)))
    a_jnp = lambda x: stencil_5pt_general(x, *coefs)  # noqa: E731
    jnp_form = chebyshev_preconditioner(
        a_jnp, lo, hi, order=order, reference_form=False,
    )
    if use_pallas not in USE_PALLAS:
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    if use_pallas == "never":
        return jnp_form
    theta, _, steps = chebyshev_k_scalars(lo, hi, order)
    steps = tuple(steps)
    coefs = tuple(float(c) for c in coefs)

    def m_inv(r):
        mode = kernel_mode(r, use_pallas)
        if mode is None:
            return jnp_form(r)
        return poly_stencil_smoother(
            r, theta, steps, coefs, interpret=(mode == "interpret")
        )

    return m_inv


def chebyshev_from_lanczos(
    A: LinearOperator,
    probe: jnp.ndarray,
    order: int = 2,
    lanczos_steps: int = 20,
    safety: float = 1.05,
    floor: Optional[float] = None,
) -> Preconditioner:
    """Build the Chebyshev preconditioner with bounds estimated by
    Lanczos — the capability the reference README claims ("spectral
    radius estimation via Lanczos iteration", README.md:11) but whose
    code does not exist; every reference driver hardcodes
    params=(8.2, 0.2) instead (test_poisson_mf.f90:38, SURVEY §2 C10).
    """
    from gmres_tpu.solvers.lanczos import lanczos_bounds

    # Estimate mode for the lower end: the rigorous lower bound is
    # typically 0 after few steps (unprovable), which would degenerate
    # the Chebyshev interval; the Ritz estimate is the usable target.
    lo, hi = lanczos_bounds(A, probe, steps=lanczos_steps,
                            rigorous=False)
    hi = float(hi) * safety
    if floor is None:
        floor = hi * 1e-8
    lo = max(float(lo) / safety, floor)
    return chebyshev_preconditioner(A, lo, hi, order=order)
