"""GCRO-DR (solvers/gcrodr.py). Oracles: dense np.linalg.solve;
cycle-count payoff vs plain GMRES on the outlier spectrum (the problem
class recycling exists for); strict acceleration of the SECOND solve
in a sequence; certified exits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.solvers.gcrodr import gcrodr


def _outlier_matrix(n=64, n_small=4, seed=0):
    rng = np.random.default_rng(seed)
    eigs = np.concatenate([
        np.linspace(1e-3, 4e-3, n_small),
        np.linspace(1.0, 2.0, n - n_small),
    ])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q @ np.diag(eigs) @ q.T


def test_single_solve_dense_oracle_and_beats_plain_gmres():
    a = _outlier_matrix(64, 4, seed=2)
    aj = jnp.asarray(a)
    b = jnp.ones((64,))
    res = gcrodr(lambda v: aj @ v, b, k=6, restart=12, tol=1e-9,
                 max_restarts=100)
    assert bool(res.converged)
    np.testing.assert_allclose(
        np.asarray(res.x), np.linalg.solve(a, np.ones(64)), atol=1e-6
    )
    plain = gt.gmres(aj, b, restart=12, tol=1e-9, max_restarts=300)
    # same memory budget: within-solve deflation already wins
    # (measured 6 vs 11 cycles)
    assert int(res.restarts) < int(plain.restarts)


def test_recycling_accelerates_second_solve():
    a1 = jnp.asarray(_outlier_matrix(64, 4, seed=2))
    # system 2: perturbed operator AND new rhs — the sequence scenario
    a2 = a1 + 1e-4 * jnp.asarray(
        np.random.default_rng(5).standard_normal((64, 64))
    )
    b2 = jnp.asarray(np.random.default_rng(1).standard_normal(64))
    r1 = gcrodr(lambda v: a1 @ v, jnp.ones((64,)), k=6, restart=12,
                tol=1e-9, max_restarts=100)
    fresh = gcrodr(lambda v: a2 @ v, b2, k=6, restart=12, tol=1e-9,
                   max_restarts=100)
    warm = gcrodr(lambda v: a2 @ v, b2, k=6, restart=12, tol=1e-9,
                  max_restarts=100, recycle=r1.recycle)
    assert bool(warm.converged)
    assert float(warm.residual) < 1e-9
    # measured 3 vs 6 cycles: the recycled invariant subspace removes
    # the outlier-relearning every fresh solve pays
    assert int(warm.restarts) < int(fresh.restarts)
    np.testing.assert_allclose(
        np.asarray(warm.x), np.asarray(fresh.x), atol=1e-6
    )


def test_preconditioned_stencil_path():
    n = 48
    op = gt.convection_diffusion_operator(n, 0.4, 0.2)
    m_inv = gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    b = op(jnp.ones((n, n)))
    res = gcrodr(op, b, k=4, restart=16, tol=1e-10, max_restarts=50,
                 M=m_inv)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)


def test_x0_and_validation():
    n = 24
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    res = gcrodr(op, b, k=3, restart=12, tol=1e-9, max_restarts=100,
                 x0=0.5 * jnp.ones((n, n)))
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)
    with pytest.raises(ValueError, match="real"):
        gcrodr(op, b.astype(jnp.complex128))
    with pytest.raises(ValueError, match="k >= 1"):
        gcrodr(op, b, k=0)
    with pytest.raises(ValueError, match="recycle must"):
        gcrodr(op, b, k=3, recycle=jnp.ones((2, n, n)))


def test_recycle_shape_and_reuse_chain():
    # recycle flows through a 3-solve chain; every solve converges and
    # the recycle block keeps its fixed shape
    a = jnp.asarray(_outlier_matrix(48, 3, seed=7))
    rng = np.random.default_rng(3)
    rec = None
    cycles = []
    for i in range(3):
        b = jnp.asarray(rng.standard_normal(48))
        r = gcrodr(lambda v: a @ v, b, k=5, restart=10, tol=1e-9,
                   max_restarts=100, recycle=rec)
        assert bool(r.converged)
        assert r.recycle.shape == (5, 48)
        cycles.append(int(r.restarts))
        rec = r.recycle
    assert cycles[1] < cycles[0] and cycles[2] <= cycles[1]


def test_sharded_parity():
    from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

    mesh = solver_mesh(8)
    n = 64
    op = gt.convection_diffusion_operator(n, 0.4, 0.2)
    b = op(jnp.ones((n, n)))
    base = gcrodr(op, b, k=6, restart=24, tol=1e-10, max_restarts=100)
    sh = jax.jit(
        lambda bb: gcrodr(op, bb, k=6, restart=24, tol=1e-10,
                          max_restarts=100)
    )(shard_grid_vector(b, mesh))
    assert bool(sh.converged)
    assert abs(int(base.restarts) - int(sh.restarts)) <= 1
    np.testing.assert_allclose(
        np.asarray(sh.x), np.asarray(base.x), atol=1e-8
    )


def test_subspace_deflation_matches_eig_quality():
    """deflation="subspace" (the complex-free route) must solve
    the same sequence workload in a comparable iteration budget to the
    exact eig extraction."""
    n = 64
    op = gt.convection_diffusion_operator(n, 0.4, 0.2)
    x_true = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, n))
    )
    b = op(x_true)
    r_eig = gcrodr(op, b, k=8, restart=30, tol=1e-9,
                   max_restarts=100, deflation="eig")
    r_sub = gcrodr(op, b, k=8, restart=30, tol=1e-9,
                   max_restarts=100, deflation="subspace")
    assert bool(r_eig.converged) and bool(r_sub.converged)
    assert int(r_sub.restarts) <= int(r_eig.restarts) + 2
    np.testing.assert_allclose(
        np.asarray(r_sub.x), np.asarray(x_true), atol=1e-6
    )
    # and the recycle pays on a second solve, same as the eig route
    b2 = op(2.0 * x_true)
    warm = gcrodr(op, b2, k=8, restart=30, tol=1e-9,
                  max_restarts=100, recycle=r_sub.recycle,
                  deflation="subspace")
    cold = gcrodr(op, b2, k=8, restart=30, tol=1e-9,
                  max_restarts=100, deflation="subspace")
    assert bool(warm.converged)
    assert int(warm.restarts) <= int(cold.restarts)


def test_mixed_precision_inner_dtype():
    """inner_dtype=float32: cycles run at work precision, x/residual
    stay f64, every boundary re-certifies the TRUE preconditioned
    residual in f64 (never the f32 Givens estimate), and the exported
    recycle block is cast back to b's dtype."""
    n = 48
    op = gt.convection_diffusion_operator(n, 0.4, 0.2)
    m_inv = gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    b = op(jnp.ones((n, n)))
    assert b.dtype == jnp.float64
    res = gcrodr(op, b, k=4, restart=16, tol=1e-10, max_restarts=80,
                 M=m_inv, inner_dtype=jnp.float32)
    assert bool(res.converged)
    assert res.x.dtype == jnp.float64
    assert res.recycle.dtype == jnp.float64
    # the certified exit residual really is below the f32 floor: the
    # f64 IR boundary is doing the convergence work
    assert float(res.residual) < 1e-10
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)
    # and the mixed recycle block warm-starts a PURE f64 solve (the
    # sequence carry is precision-agnostic)
    b2 = op(jnp.full((n, n), 2.0))
    warm = gcrodr(op, b2, k=4, restart=16, tol=1e-10, max_restarts=80,
                  M=m_inv, recycle=res.recycle)
    cold = gcrodr(op, b2, k=4, restart=16, tol=1e-10, max_restarts=80,
                  M=m_inv)
    assert bool(warm.converged)
    assert int(warm.restarts) <= int(cold.restarts)


def test_mixed_precision_sharded_parity():
    """The mixed path under GSPMD: iteration/cycle counts over the
    8-device mesh must equal the single-device run exactly."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = 48
    op = gt.convection_diffusion_operator(n, 0.4, 0.2)
    b = op(jnp.ones((n, n)))
    run = lambda bb: gcrodr(op, bb, k=4, restart=16, tol=1e-9,  # noqa: E731
                            max_restarts=80, inner_dtype=jnp.float32)
    ref = run(b)
    mesh = jax.make_mesh((8,), ("grid",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    b_sh = jax.device_put(b, NamedSharding(mesh, P("grid", None)))
    sh = jax.jit(run)(b_sh)
    assert bool(sh.converged)
    assert int(sh.restarts) == int(ref.restarts)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x),
                               atol=1e-6)
