"""Batched solves: every solver is a pure function of pytrees, so
``jax.vmap`` turns it into a batched solver for free — many right-hand
sides (or many grids of the same size) solved in one compiled program,
with all the vector work batched. The reference would
need an outer Fortran loop per system."""

import jax
import jax.numpy as jnp
import numpy as np

import gmres_tpu as gt


def _rhs_batch(n, k):
    op = gt.poisson_operator(n)
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.standard_normal((k, n, n)))
    bs = jax.vmap(op)(xs)
    return op, xs, bs


def test_vmap_cg():
    n, k = 16, 4
    op, xs, bs = _rhs_batch(n, k)
    solve = jax.vmap(
        lambda b: gt.cg(op, b, tol=1e-10, max_iterations=2000)
    )
    res = solve(bs)
    assert res.x.shape == (k, n, n)
    assert bool(jnp.all(res.status == 0))
    np.testing.assert_allclose(res.x, xs, atol=1e-7)


def test_vmap_gmres():
    n, k = 12, 3
    op, xs, bs = _rhs_batch(n, k)
    solve = jax.vmap(
        lambda b: gt.gmres(op, b, restart=30, tol=1e-10,
                           max_restarts=100, compute_v_err=False)
    )
    res = solve(bs)
    assert res.x.shape == (k, n, n)
    assert bool(jnp.all(res.status == 0))
    np.testing.assert_allclose(res.x, xs, atol=1e-6)


def test_vmap_bicgstab():
    n, k = 12, 3
    op, xs, bs = _rhs_batch(n, k)
    res = jax.vmap(
        lambda b: gt.bicgstab(op, b, tol=1e-10, max_iterations=2000)
    )(bs)
    assert bool(jnp.all(res.status == 0))
    np.testing.assert_allclose(res.x, xs, atol=1e-6)


def test_vmap_per_lane_parity():
    # vmap's while_loop batching masks finished lanes, so each lane
    # reproduces its sequential trajectory exactly — iteration counts
    # and solutions, not just convergence.
    n = 32
    op = gt.poisson_operator(n)
    rng = np.random.default_rng(3)
    bs = jnp.asarray(rng.standard_normal((6, n, n)))
    batched = jax.jit(
        jax.vmap(lambda b: gt.cg(op, b, tol=1e-10, max_iterations=500))
    )(bs)
    for k in range(6):
        single = gt.cg(op, bs[k], tol=1e-10, max_iterations=500)
        assert int(batched.iterations[k]) == int(single.iterations)
        assert int(batched.status[k]) == int(single.status)
        np.testing.assert_allclose(
            np.asarray(batched.x[k]), np.asarray(single.x), atol=1e-12
        )


def test_vmap_over_operator_parameters():
    # One dispatch sweeps the operator FAMILY: per-lane convection
    # strengths, not just per-lane right-hand sides.
    from gmres_tpu.models.convection_diffusion import (
        convection_diffusion_apply,
    )

    n = 32
    gammas = jnp.asarray([0.0, 0.2, 0.4, 0.8])
    b = jnp.ones((n, n))

    def solve(gx):
        op = lambda v: convection_diffusion_apply(v, gx, 0.5 * gx)
        return gt.bicgstab(op, op(b), tol=1e-9, max_iterations=2000)

    res = jax.jit(jax.vmap(solve))(gammas)
    assert bool(jnp.all(res.status == gt.SolverStatus.CONVERGED))
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)
    single = solve(gammas[2])
    # batching changes XLA fusion and hence last-ulp rounding; the
    # trajectory is identical up to a ±1 tol-boundary crossing
    assert abs(int(res.iterations[2]) - int(single.iterations)) <= 1


def test_vmap_newton_continuation():
    # Nonlinear continuation: the whole Bratu λ-sweep is ONE batched
    # JFNK dispatch; ‖u‖ grows monotonically toward the fold λ*≈6.8.
    from gmres_tpu.models.poisson import poisson_apply

    n = 24
    h2 = (1.0 / (n + 1)) ** 2
    lams = jnp.asarray([1.0, 3.0, 5.0, 6.5])

    def solve(lam):
        F = lambda u: poisson_apply(u) - (lam * h2) * jnp.exp(u)
        return gt.newton_krylov(F, jnp.zeros((n, n)), tol=1e-10,
                                restart=20)

    res = jax.jit(jax.vmap(solve))(lams)
    assert bool(jnp.all(res.status == gt.SolverStatus.CONVERGED))
    umax = np.asarray(jnp.max(res.x, axis=(1, 2)))
    assert np.all(np.diff(umax) > 0)
    single = solve(lams[3])
    np.testing.assert_allclose(
        np.asarray(res.x[3]), np.asarray(single.x), atol=1e-9
    )
