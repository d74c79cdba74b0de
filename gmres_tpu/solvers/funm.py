"""Krylov matrix functions: f(A)·b without forming f(A).

Beyond the reference (polynomial solves only): production workloads
need the ACTION of matrix functions — the heat semigroup exp(−tA)·b
(exponential integrators, diffusion propagators), A^{−1/2}·b (Gaussian
sampling, whitening), log/fractional powers (spectral filters). The
Lanczos/Arnoldi method computes them all from ONE Krylov basis:

    f(A)·b ≈ ‖b‖ · V_m · f(H_m) · e₁,     A V_m = V_{m+1} H̄_m

with f applied to the TINY (m, m) projected matrix by dense
eigendecomposition (Saad, SINUM 29(1), 1992). Polynomial-exactness:
the approximation is exact for f any polynomial of degree < m, and
for entire f (exp) converges superlinearly once m exceeds the
spectral-interval width measure √(t·λmax).

Device shape: the basis build is :func:`arnoldi_factorization`'s CGS2
loop (full reorthogonalization — plain three-term Lanczos loses
orthogonality exactly when f(A) needs it most; CGS2 costs one fused
matmul pass), the eigenproblem is a replicated
(m, m) ``jnp.linalg.eigh``, and the combination is one tall matmul.
Several f's / several time points reuse the SAME basis at the cost of
an (m × nt) small matmul — ``expm_multiply`` accepts a vector t and
returns all snapshots from one factorization, one dispatch.

Symmetry: H_m is symmetrized before eigh. For symmetric A this only
removes roundoff; for nonsymmetric A it computes f at the HERMITIAN
PART's Ritz values — the returned ``asymmetry`` diagnostic reports
max|H−Hᵀ| so callers can detect misuse (same honest-diagnostics
policy as the exit certification, PARITY.md quirk 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, tree_vdot
from gmres_tpu.solvers.lanczos import arnoldi_factorization
from gmres_tpu.types import LinearOperator


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FunmResult:
    """Result of :func:`funm_lanczos` / :func:`expm_multiply`.

    Attributes:
      y: f(A)·b approximation — shape of b, or (nt, *shape) when
        expm_multiply got a vector of times.
      error_estimate: Saad's a-posteriori indicator
        ‖b‖·β_m·|eₘᵀ f(H) e₁| — the norm of the first neglected term;
        scalar, or (nt,) for vector t (max over f's when stacked).
      asymmetry: max|H − Hᵀ| over the built Krylov pencil — ~ε‖A‖ for
        symmetric operators; O(‖A‖) means A was not symmetric and the
        result is f of the Hermitian part only.
    """

    y: Any
    error_estimate: jnp.ndarray
    asymmetry: jnp.ndarray


def _funm_core(A, b, steps):
    basis, hmat = arnoldi_factorization(A, b, steps)
    h = hmat[:steps, :steps]
    asym = jnp.max(jnp.abs(h - h.T))
    theta, q = jnp.linalg.eigh(0.5 * (h + h.T))
    beta0 = jnp.sqrt(tree_vdot(b, b))
    beta_m = hmat[steps, steps - 1]
    return basis, theta, q, beta0, beta_m, asym


def funm_lanczos(
    A: LinearOperator,
    b: jnp.ndarray,
    f: Callable,
    *,
    steps: int = 30,
) -> FunmResult:
    """Approximate f(A)·b for symmetric A by steps-step Lanczos.

    Args:
      A: symmetric linear operator callable (positive-definite for
        fractional/inverse f — f is evaluated only at Ritz values,
        which lie inside A's spectral interval, so f need only be
        defined there).
      b: vector (any array shape).
      f: elementwise spectral map, jnp-traceable — e.g.
        ``lambda s: 1/jnp.sqrt(s)`` for A^{−1/2}·b,
        ``jnp.log`` for log(A)·b.
      steps: Krylov dimension m (exact when m reaches the number of
        distinct eigenvalues represented in b).
    """
    basis, theta, q, beta0, beta_m, asym = _funm_core(A, b, steps)
    w = q @ (f(theta) * q[0, :])        # f(H) e1
    y = beta0 * row_combine(w, basis[:steps])
    err = beta0 * jnp.abs(beta_m) * jnp.abs(w[steps - 1])
    return FunmResult(y=y, error_estimate=err, asymmetry=asym)


def expm_multiply(
    A: LinearOperator,
    b: jnp.ndarray,
    t=1.0,
    *,
    steps: int = 30,
) -> FunmResult:
    """Heat-semigroup action exp(−t·A)·b (sign convention matches
    :func:`gmres_tpu.solvers.evolve.theta_evolve`: A is the POSITIVE
    definite spatial operator, so states decay).

    t: scalar, or a 1-D array of times — all snapshots are computed
    from ONE Krylov factorization (the expensive part); y gains a
    leading (nt,) axis. Time accuracy is spectral (no O(Δt²) step
    error — the comparison tests/test_funm.py pins against
    Crank–Nicolson's).
    """
    t_arr = jnp.atleast_1d(jnp.asarray(t, b.dtype))
    basis, theta, q, beta0, beta_m, asym = _funm_core(A, b, steps)
    # (nt, m): f(H) e1 for every time point, one small matmul.
    w = jnp.einsum(
        "ij,tj,j->ti", q, jnp.exp(-t_arr[:, None] * theta), q[0, :]
    )
    y = beta0 * row_combine(w.T, basis[:steps])
    err = beta0 * jnp.abs(beta_m) * jnp.abs(w[:, steps - 1])
    if jnp.ndim(t) == 0:
        y, err = y[0], err[0]
    return FunmResult(y=y, error_estimate=err, asymmetry=asym)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Result of :func:`trace_funm` (stochastic Lanczos quadrature).

    Attributes:
      value: tr f(A) estimate (mean over probes).
      stderr: standard error of the probe mean — the Monte-Carlo
        uncertainty (the Lanczos quadrature error per probe is
        separate and decays exponentially in steps).
      samples: (n_probes,) per-probe estimates zᵀf(A)z.
    """

    value: jnp.ndarray
    stderr: jnp.ndarray
    samples: jnp.ndarray


def trace_funm(
    A: LinearOperator,
    f: Callable,
    x_like: jnp.ndarray,
    *,
    n_probes: int = 16,
    steps: int = 30,
    key=None,
) -> TraceResult:
    """Estimate tr f(A) for symmetric A by stochastic Lanczos
    quadrature (Ubaru, Chen, Saad — SIMAX 38(4), 2017):

        tr f(A) ≈ (1/m) Σᵢ zᵢᵀ f(A) zᵢ,   zᵢ Rademacher,

    each quadrature zᵀf(A)z = ‖z‖²·e₁ᵀf(T_m)e₁ from one Lanczos
    factorization — the log-det / trace-inverse workhorse (Gaussian
    process likelihoods: log det A = tr log A).

    Device shape: the probes are INDEPENDENT — ``jax.vmap`` over the
    whole factorization turns m probes into batched stencil applies
    and batched small eighs, the same batching economics as the
    multi-RHS solvers (DESIGN.md §4c). One dispatch, no loop.

    Args:
      A: symmetric operator callable.
      f: elementwise spectral map (``jnp.log`` for log-det,
        ``lambda s: 1/s`` for tr A⁻¹).
      x_like: array of A's operand shape/dtype (gives the probe
        shape).
      n_probes: Monte-Carlo sample count m (variance ∝ 1/m).
      steps: Lanczos steps per probe.
      key: PRNG key (default deterministic PRNGKey(0) — reproducible,
        jit-friendly).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    shape = x_like.shape
    dtype = x_like.dtype
    z = jax.random.rademacher(
        key, (n_probes,) + shape, dtype=dtype
    )

    def one(zi):
        basis, hmat = arnoldi_factorization(A, zi, steps)
        h = hmat[:steps, :steps]
        theta, q = jnp.linalg.eigh(0.5 * (h + h.T))
        nrm2 = tree_vdot(zi, zi)  # = N exactly for Rademacher
        return nrm2 * jnp.sum(f(theta) * q[0, :] ** 2)

    samples = jax.vmap(one)(z)
    value = jnp.mean(samples)
    stderr = jnp.std(samples) / jnp.sqrt(1.0 * n_probes)
    return TraceResult(value=value, stderr=stderr, samples=samples)
