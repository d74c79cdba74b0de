"""GMRES-DR tests: oracle trajectory parity, deflation payoff where
restarted GMRES stagnates, sharded parity, and edge probes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

import gmres_tpu as gt
from gmres_tpu.solvers.gmres_dr import gmres_dr
from gmres_tpu.types import SolverStatus
from tests.golden import golden_gmres_dr


def _outlier_matrix(n=64, n_small=4, seed=0):
    """SPD-like dense matrix with a few tiny outlying eigenvalues —
    the problem class deflated restarting exists for."""
    rng = np.random.default_rng(seed)
    eigs = np.concatenate([
        np.linspace(1e-3, 4e-3, n_small),
        np.linspace(1.0, 2.0, n - n_small),
    ])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q @ np.diag(eigs) @ q.T


def test_oracle_trajectory_parity():
    """Both implementations minimize over the same per-cycle subspace,
    so true-residual norms after each restart must agree."""
    a = _outlier_matrix(48, n_small=3, seed=1)
    b = np.ones(48)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    _, hist = golden_gmres_dr(lambda v: a @ v, b, m=10, k=4,
                              tol=1e-9, max_restarts=12)
    for j in range(1, min(len(hist), 6)):
        res = gmres_dr(aj, bj, restart=10, deflate=4, tol=1e-9,
                       max_restarts=j)
        got = float(res.residual)
        if hist[j] > 1e-8:
            # rounding-dominated regime not yet reached: tight parity
            assert abs(got - hist[j]) <= 1e-6 * hist[j], (
                f"cycle {j}: {got} vs oracle {hist[j]}"
            )
        else:
            # below ~eps*cond the two routes' subspaces differ at
            # rounding level; both must sit at the converged floor
            assert got < 5e-9, f"cycle {j}: {got} vs oracle {hist[j]}"


def test_deflation_beats_stagnating_restart():
    """On the outlier spectrum GMRES(10) stagnates for hundreds of
    cycles; GMRES-DR(10,4) converges in a handful."""
    a = jnp.asarray(_outlier_matrix(64, n_small=4, seed=2))
    b = jnp.ones((64,))
    res_dr = gmres_dr(a, b, restart=10, deflate=4, tol=1e-9,
                      max_restarts=60)
    res_g = gt.gmres(a, b, restart=10, tol=1e-9, max_restarts=60,
                     variant="householder")
    assert int(res_dr.status) == int(SolverStatus.CONVERGED)
    assert int(res_dr.restarts) < 30
    # plain restarted either fails outright or needs far more cycles
    assert (int(res_g.status) != int(SolverStatus.CONVERGED)
            or int(res_g.restarts) > 2 * int(res_dr.restarts))
    x = np.linalg.solve(np.asarray(a), np.asarray(b))
    assert float(jnp.max(jnp.abs(res_dr.x - x))) < 1e-6


def test_poisson_converges_and_beats_plain():
    n = 48
    a = gt.poisson_operator(n)
    b = a(jnp.ones((n, n)))
    res = gmres_dr(a, b, restart=30, deflate=10, tol=1e-10,
                   max_restarts=100)
    ref = gt.gmres(a, b, restart=30, tol=1e-10, max_restarts=100,
                   variant="householder")
    assert int(res.status) == int(SolverStatus.CONVERGED)
    assert float(jnp.max(jnp.abs(res.x - 1.0))) < 1e-8
    assert int(res.restarts) <= int(ref.restarts)


def test_right_preconditioned():
    n = 48
    a = gt.poisson_operator(n)
    b = a(jnp.ones((n, n)))
    m_inv = gt.chebyshev_preconditioner(a, 0.2, 8.2)
    res = gmres_dr(a, b, restart=20, deflate=5, tol=1e-12, M=m_inv,
                   max_restarts=100)
    assert int(res.status) == int(SolverStatus.CONVERGED)
    assert float(jnp.max(jnp.abs(res.x - 1.0))) < 1e-9


def test_nonsymmetric_complex_pairs():
    """Convection-diffusion: harmonic Ritz values arrive in conjugate
    pairs — exercises the realification + straddle machinery."""
    n = 40
    a = gt.convection_diffusion_operator(n, 2.0, 1.0)
    b = a(jnp.ones((n, n)))
    res = gmres_dr(a, b, restart=25, deflate=8, tol=1e-10,
                   max_restarts=200)
    ref = gt.gmres(a, b, restart=25, tol=1e-10, max_restarts=200,
                   variant="householder")
    assert int(res.status) == int(SolverStatus.CONVERGED)
    assert float(jnp.max(jnp.abs(res.x - 1.0))) < 1e-7
    assert int(res.restarts) <= int(ref.restarts)


def test_deflate_zero_matches_restarted_gmres():
    n = 32
    a = gt.poisson_operator(n)
    b = a(jnp.ones((n, n)))
    res0 = gmres_dr(a, b, restart=15, deflate=0, tol=1e-9,
                    max_restarts=300)
    ref = gt.gmres(a, b, restart=15, tol=1e-9, max_restarts=300,
                   variant="householder")
    assert int(res0.status) == int(SolverStatus.CONVERGED)
    # identical minimization spaces: same cycle count
    assert int(res0.restarts) == int(ref.restarts)


def test_sharded_parity():
    n = 48
    a = gt.poisson_operator(n)
    b = a(jnp.ones((n, n)))
    res_rep = jax.jit(
        lambda bb: gmres_dr(a, bb, restart=20, deflate=6, tol=1e-10,
                            max_restarts=100)
    )(b)
    mesh = jax.make_mesh((8,), ("grid",), axis_types=(AxisType.Auto,))
    b_sh = jax.device_put(b, NamedSharding(mesh, P("grid", None)))
    res_sh = jax.jit(
        lambda bb: gmres_dr(a, bb, restart=20, deflate=6, tol=1e-10,
                            max_restarts=100)
    )(b_sh)
    assert int(res_sh.restarts) == int(res_rep.restarts)
    assert int(res_sh.iterations) == int(res_rep.iterations)
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_rep.x), atol=1e-9
    )


def test_f32_path():
    n = 32
    a32 = lambda v: gt.poisson_operator(n)(v)
    b = jnp.asarray(
        np.asarray(gt.poisson_operator(n)(jnp.ones((n, n)))),
        dtype=jnp.float32,
    )
    res = gmres_dr(a32, b, restart=20, deflate=6, tol=1e-5,
                   max_restarts=100)
    assert int(res.status) == int(SolverStatus.CONVERGED)
    assert res.x.dtype == jnp.float32
    assert float(jnp.max(jnp.abs(res.x - 1.0))) < 1e-3


def test_zero_rhs_and_1x1():
    a = gt.poisson_operator(16)
    r0 = gmres_dr(a, jnp.zeros((16, 16)), restart=8, deflate=2,
                  tol=1e-10)
    assert int(r0.status) == int(SolverStatus.CONVERGED)
    assert int(r0.restarts) == 0
    r1 = gmres_dr(jnp.asarray([[4.0]]), jnp.asarray([[8.0]]),
                  restart=5, deflate=2, tol=1e-12)
    assert float(r1.x[0, 0]) == pytest.approx(2.0)


def test_max_restarts_status():
    a = jnp.asarray(_outlier_matrix(64, n_small=6, seed=3))
    b = jnp.ones((64,))
    res = gmres_dr(a, b, restart=8, deflate=2, tol=1e-14,
                   max_restarts=2)
    assert int(res.status) == int(SolverStatus.MAX_ITERATIONS)


def test_subspace_deflation_matches_eig_quality():
    """deflation="subspace" (the complex-free route) converges in
    a comparable cycle count to the exact eig extraction on the
    small-eigenvalue-dominated workload GMRES-DR exists for."""
    n = 48
    op = gt.poisson_operator(n)
    x_true = jnp.asarray(
        np.random.default_rng(1).standard_normal((n, n))
    )
    b = op(x_true)
    r_eig = gt.gmres_dr(op, b, restart=25, deflate=8, tol=1e-9,
                        max_restarts=400, deflation="eig")
    r_sub = gt.gmres_dr(op, b, restart=25, deflate=8, tol=1e-9,
                        max_restarts=400, deflation="subspace")
    assert bool(r_eig.converged) and bool(r_sub.converged)
    assert int(r_sub.restarts) <= int(r_eig.restarts) * 2
    np.testing.assert_allclose(
        np.asarray(r_sub.x), np.asarray(x_true), atol=1e-6
    )
