"""Explicit shard_map halo-exchange stencil vs the GSPMD/jnp operator
(SURVEY §2 parallelism item 2), on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.parallel.halo import halo_poisson_operator, halo_stencil_operator
from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh
from gmres_tpu.models.convection_diffusion import (
    convection_diffusion_apply,
    convection_diffusion_coefs,
)


@pytest.fixture(scope="module")
def mesh():
    return solver_mesh(8)


def test_halo_poisson_matches_jnp(mesh):
    n = 32
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n, n)))
    x_sh = shard_grid_vector(x, mesh)
    op = halo_poisson_operator(mesh)
    y = jax.jit(op)(x_sh)
    np.testing.assert_allclose(y, gt.poisson_apply(x), rtol=1e-13)


def test_halo_general_coefs(mesh):
    n = 16
    coefs = convection_diffusion_coefs(0.4, 0.2)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((n, n)))
    op = halo_stencil_operator(mesh, coefs)
    y = jax.jit(op)(shard_grid_vector(x, mesh))
    np.testing.assert_allclose(
        y, convection_diffusion_apply(x, 0.4, 0.2), rtol=1e-13
    )


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_halo_general_coefs_device_counts(n_devices):
    """The jnp halo operator with general (convection-diffusion)
    coefficients on 2, 4 and 8 virtual devices."""
    mesh_n = solver_mesh(n_devices)
    n = 8 * n_devices
    coefs = convection_diffusion_coefs(0.4, 0.2)
    x = jnp.asarray(np.random.default_rng(n_devices).standard_normal((n, n)))
    y = jax.jit(halo_stencil_operator(mesh_n, coefs))(
        shard_grid_vector(x, mesh_n))
    np.testing.assert_allclose(
        y, convection_diffusion_apply(x, 0.4, 0.2), rtol=1e-13
    )


def test_halo_operator_drives_cg(mesh):
    """The distributed operator composes with the solvers untouched,
    and iteration counts match the single-device operator exactly."""
    n = 40
    op = halo_poisson_operator(mesh)
    b_plain = gt.poisson_apply(jnp.ones((n, n)))
    b = shard_grid_vector(b_plain, mesh)
    res = jax.jit(lambda v: gt.cg(op, v, tol=1e-9, max_iterations=2000))(b)
    ref = gt.cg(gt.poisson_operator(n), b_plain, tol=1e-9,
                max_iterations=2000)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-6)


def test_halo_operator_drives_gmres(mesh):
    n = 24
    op = halo_poisson_operator(mesh)
    m_inv = gt.chebyshev_preconditioner(op, 0.2, 8.2)
    b = shard_grid_vector(gt.poisson_apply(jnp.ones((n, n))), mesh)
    res = jax.jit(
        lambda v: gt.gmres(op, v, restart=30, tol=1e-10, M=m_inv,
                           max_restarts=100, compute_v_err=False)
    )(b)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-7)
