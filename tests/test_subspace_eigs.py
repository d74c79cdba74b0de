"""Real subspace-iteration eigensolver (solvers/subspace_eigs.py) —
the complex-free route for dominant nonsymmetric eigenpairs.
Oracles: the closed-form convection-diffusion tensor spectrum and
numpy.linalg.eig on the dense assembly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.models.convection_diffusion import (
    convection_diffusion_eigenvalues,
)


def _keyed(v):
    # conjugate-pair sign freedom: compare as multisets
    return np.sort_complex(v.real + 1j * np.abs(v.imag))


def test_separated_spectrum_is_exact():
    """Well-separated dominant moduli: the Ritz pairs converge to
    near-machine accuracy (the method's clean regime)."""
    rng = np.random.default_rng(0)
    n, k = 60, 3
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[9.0, 6.0, 4.0], rng.uniform(0.1, 1.5, n - 3)])
    a = (q * lam) @ q.T
    aj = jnp.asarray(a)
    res = gt.subspace_eigs(lambda v: aj @ v, jnp.ones((n,)), nev=k,
                           guard=4, iters=300, tol=1e-8)
    np.testing.assert_allclose(
        np.sort(np.asarray(res.eigenvalues.real))[::-1],
        [9.0, 6.0, 4.0], rtol=1e-9,
    )
    assert float(jnp.max(res.residuals)) < 1e-8
    assert bool(res.status == 0)


def test_clustered_spectrum_estimation_grade():
    """Convection-dominated convdiff: the dominant conjugate pairs sit
    within 0.2% in modulus — the documented estimation-grade regime
    (~0.5% Ritz values, ~2e-3 residuals; a linear-rate iteration
    cannot split what Krylov's polynomial can)."""
    n, k = 48, 4
    gx, gy = 2.0, 0.5
    op = gt.convection_diffusion_operator(n, gx, gy)
    res = gt.subspace_eigs(op, jnp.ones((n, n)), nev=k, guard=6,
                           iters=600)
    exact = convection_diffusion_eigenvalues(n, gx, gy)
    exact = exact[np.argsort(-np.abs(exact))][:k]
    np.testing.assert_allclose(
        _keyed(np.asarray(res.eigenvalues)), _keyed(exact), rtol=2e-2
    )
    assert float(jnp.max(res.residuals)) < 1e-2


def test_residuals_are_true():
    """Recompute ||A x - lam x|| outside the solver (complex, host)."""
    n, k = 32, 3
    op = gt.convection_diffusion_operator(n, 1.5, 0.4)
    res = gt.subspace_eigs(op, jnp.ones((n, n)), nev=k, guard=5,
                           iters=500)
    for i in range(k):
        x = np.asarray(res.x[i])
        lam = complex(res.eigenvalues[i])
        ax = np.asarray(op(jnp.asarray(x.real))) + 1j * np.asarray(
            op(jnp.asarray(x.imag)))
        r = np.linalg.norm(ax - lam * x)
        np.testing.assert_allclose(
            r, float(res.residuals[i]), rtol=1e-8, atol=1e-12
        )


def test_which_lm_only():
    with pytest.raises(ValueError, match="LM"):
        gt.subspace_eigs(lambda v: v, jnp.ones((8, 8)), which="SM")


def test_sharded_parity():
    from gmres_tpu.parallel.mesh import solver_mesh

    n, k = 32, 3
    op = gt.convection_diffusion_operator(n, 1.5, 0.4)
    rep = gt.subspace_eigs(op, jnp.ones((n, n)), nev=k, guard=5,
                           iters=300)
    mesh = solver_mesh(8)
    with mesh:
        sh = gt.subspace_eigs(op, jnp.ones((n, n)), nev=k, guard=5,
                              iters=300)
    np.testing.assert_allclose(
        _keyed(np.asarray(sh.eigenvalues)),
        _keyed(np.asarray(rep.eigenvalues)), rtol=1e-10,
    )
