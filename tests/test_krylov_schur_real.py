"""Krylov-Schur on a real Schur basis (solvers/krylov_schur_real.py).

Oracles: np.linalg.eigvals on dense assemblies (the repo convention
for eigensolvers, tests/test_arnoldi_eigs.py); closed-form Poisson
extremes; certification cross-checks; parity with the complex-basis
arnoldi_eigs on the clustered convection-dominated spectrum that
defeats subspace iteration; sharded CPU-mesh parity."""

import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.models.convection_diffusion import (
    convection_diffusion_matrix,
)


def _probe(shape, seed=1):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape)
    )


def _pair_keys(vals):
    return np.sort(vals.real), np.sort(np.abs(vals.imag))


def test_dense_nonsymmetric_oracle_lm():
    rng = np.random.default_rng(0)
    d = 60
    a = rng.standard_normal((d, d)) + np.diag(np.arange(d, dtype=float))
    aj = jnp.asarray(a)
    r = gt.arnoldi_eigs_real(
        lambda v: aj @ v, _probe(d), nev=4, steps=30, which="LM",
        tol=1e-8,
    )
    assert bool(r.converged)
    assert np.all(np.asarray(r.residuals) < 1e-8)
    ev = np.linalg.eigvals(a)
    ev = ev[np.argsort(-np.abs(ev))][:4]
    got = np.asarray(r.eigenvalues)
    for g, e in zip(_pair_keys(got), _pair_keys(ev)):
        np.testing.assert_allclose(g, e, atol=1e-7)
    # certified residual really is ‖A x − λ x‖ for unit x
    x0 = np.asarray(r.x[0])
    assert abs(np.linalg.norm(x0) - 1.0) < 1e-10
    assert np.linalg.norm(a @ x0 - got[0] * x0) < 1e-7


def test_poisson_lm_matches_closed_form():
    n = 24
    op = gt.poisson_operator(n)
    r = gt.arnoldi_eigs_real(op, _probe((n, n)), nev=2, steps=26,
                             which="LM", tol=1e-9)
    assert bool(r.converged)
    _, hi = gt.poisson_spectral_bounds(n)
    np.testing.assert_allclose(
        float(np.asarray(r.eigenvalues)[0].real), hi, rtol=1e-9
    )
    assert abs(complex(np.asarray(r.eigenvalues)[0]).imag) < 1e-9


def test_convdiff_clustered_complex_pairs_vs_dense():
    """The convection-dominated regime whose CLUSTERED moduli defeat
    subspace iteration (17-50% eigenvalue errors were recorded
    there): the real-Schur Krylov route must reach
    the same certified accuracy as the complex-basis solver."""
    n = 16
    a = np.asarray(convection_diffusion_matrix(n, 2.0, 0.5))
    op = gt.convection_diffusion_operator(n, 2.0, 0.5)
    r = gt.arnoldi_eigs_real(op, _probe((n, n)), nev=4, steps=20,
                             which="LM", tol=1e-9, max_restarts=200)
    assert bool(r.converged)
    assert np.all(np.asarray(r.residuals) < 1e-9)
    ev = np.linalg.eigvals(a)
    ev = ev[np.argsort(-np.abs(ev))][:4]
    got = np.asarray(r.eigenvalues)
    for g, e in zip(_pair_keys(got), _pair_keys(ev)):
        np.testing.assert_allclose(g, e, atol=1e-5)
    # genuinely complex pairs found with NO complex device arithmetic
    assert np.max(np.abs(got.imag)) > 1.0


def test_matches_complex_basis_solver():
    # γ=(2.0, 0.5): the convection-dominated config the complex-basis
    # solver is tested on (test_arnoldi_eigs.py). Configurations with
    # BOTH γ near 1 produce grid spectra so modulus-clustered that the
    # complex solver itself stalls at ~1e-3 — not a usable parity bar.
    n = 16
    op = gt.convection_diffusion_operator(n, 2.0, 0.5)
    real = gt.arnoldi_eigs_real(op, _probe((n, n)), nev=4, steps=20,
                                tol=1e-9, max_restarts=200)
    cplx = gt.arnoldi_eigs(op, _probe((n, n)), nev=4, steps=20,
                           tol=1e-9, max_restarts=200)
    assert bool(real.converged) and bool(cplx.converged)
    for g, e in zip(
        _pair_keys(np.asarray(real.eigenvalues)),
        _pair_keys(np.asarray(cplx.eigenvalues)),
    ):
        np.testing.assert_allclose(g, e, atol=1e-8)


def test_smallest_real_part():
    rng = np.random.default_rng(3)
    d = 50
    a = np.diag(np.linspace(1.0, 50.0, d)) + 0.1 * rng.standard_normal(
        (d, d)
    )
    aj = jnp.asarray(a)
    r = gt.arnoldi_eigs_real(lambda v: aj @ v, _probe(d), nev=3,
                             steps=28, which="SR", tol=1e-8,
                             max_restarts=300)
    assert bool(r.converged)
    ev = np.linalg.eigvals(a)
    ev = ev[np.argsort(ev.real)][:3]
    np.testing.assert_allclose(
        np.sort(np.asarray(r.eigenvalues).real), np.sort(ev.real),
        atol=1e-6,
    )


def test_rejects_complex_probe_and_bad_which():
    with pytest.raises(ValueError, match="REAL-operator"):
        gt.arnoldi_eigs_real(
            lambda v: v, jnp.ones((8,), dtype=jnp.complex128)
        )
    with pytest.raises(ValueError, match="which"):
        gt.arnoldi_eigs_real(lambda v: v, jnp.ones((8, 8)),
                             which="XX")


def test_sharded_parity():
    from gmres_tpu.parallel.mesh import solver_mesh

    n = 16
    op = gt.convection_diffusion_operator(n, 2.0, 0.5)
    rep = gt.arnoldi_eigs_real(op, _probe((n, n)), nev=3, steps=20,
                               tol=1e-9, max_restarts=200)
    mesh = solver_mesh(8)
    with mesh:
        sh = gt.arnoldi_eigs_real(op, _probe((n, n)), nev=3, steps=20,
                                  tol=1e-9, max_restarts=200)
    assert bool(rep.converged) and bool(sh.converged)
    for g, e in zip(
        _pair_keys(np.asarray(sh.eigenvalues)),
        _pair_keys(np.asarray(rep.eigenvalues)),
    ):
        np.testing.assert_allclose(g, e, atol=1e-9)
