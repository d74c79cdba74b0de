"""The fused distributed Chebyshev preconditioner (one halo exchange and
one pass per cbpr2 application) against the single-device forms."""

import jax
import jax.numpy as jnp
import numpy as np

import gmres_tpu as gt
from gmres_tpu.parallel.halo import (
    halo_chebyshev_preconditioner,
    halo_poisson_operator,
)
from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh


def _rand(shape, seed, dtype=np.float32):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    )


def test_halo_chebyshev_preconditioner_jnp():
    mesh = solver_mesh(8)
    n = 32
    r = _rand((n, n), 7, np.float64)
    m_dist = halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    z = jax.jit(m_dist)(shard_grid_vector(r, mesh))
    z_ref = gt.chebyshev_preconditioner(gt.poisson_operator(n), 0.2,
                                        8.2)(r)
    np.testing.assert_allclose(z, z_ref, rtol=1e-13)


def test_fused_preconditioner_drives_solver():
    """Distributed fused preconditioner inside PCG: same iteration
    count as the plain composition."""
    mesh = solver_mesh(8)
    n = 40
    op = halo_poisson_operator(mesh)
    m_dist = halo_chebyshev_preconditioner(mesh, 0.2, 8.2)
    b = shard_grid_vector(gt.poisson_apply(jnp.ones((n, n))), mesh)
    res = jax.jit(
        lambda v: gt.cg(op, v, tol=1e-9, max_iterations=2000, M=m_dist)
    )(b)
    ref = gt.cg(
        gt.poisson_operator(n),
        gt.poisson_apply(jnp.ones((n, n))),
        tol=1e-9, max_iterations=2000,
        M=gt.chebyshev_preconditioner(gt.poisson_operator(n), 0.2, 8.2),
    )
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-6)


def test_halo_chebyshev_high_order():
    """order>2 distributed Chebyshev composes the semi-iteration over
    the halo operator; must match the single-device recurrence."""
    mesh = solver_mesh(8)
    n = 32
    r = _rand((n, n), 11, np.float64)
    m_dist = halo_chebyshev_preconditioner(mesh, 0.005, 8.0, order=8)
    z = jax.jit(m_dist)(shard_grid_vector(r, mesh))
    z_ref = gt.chebyshev_preconditioner(
        gt.poisson_operator(n), 0.005, 8.0, order=8, reference_form=False
    )(r)
    np.testing.assert_allclose(z, z_ref, rtol=1e-12)
