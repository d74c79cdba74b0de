"""Split-complex Helmholtz (models/helmholtz.py:helmholtz_split_operator
+ the layout="split" CSL cycle). The route for the complex class on
runtimes without a complex datapath — pinned here against the c128
oracles on the CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

import gmres_tpu as gt
from gmres_tpu.precond.multigrid import csl_multigrid_preconditioner


def _rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    )


def test_split_operator_matches_complex():
    n, kh2, damping = 32, 0.25, 0.3
    op_c = gt.helmholtz_operator(n, kh2, damping)
    op_s = gt.helmholtz_split_operator(n, kh2, damping)
    u = _rand_complex(n)
    yc = op_c(u)
    ys = op_s(gt.complex_to_split(u))
    np.testing.assert_allclose(
        np.asarray(gt.split_to_complex(ys)), np.asarray(yc), atol=1e-13
    )


def test_split_csl_cycle_matches_complex():
    n, kh2 = 32, 0.25
    m_c = csl_multigrid_preconditioner(n, kh2)
    m_s = csl_multigrid_preconditioner(n, kh2, layout="split")
    r = _rand_complex(n, 1)
    zc = m_c(r)
    zs = m_s(gt.complex_to_split(r))
    np.testing.assert_allclose(
        np.asarray(gt.split_to_complex(zs)), np.asarray(zc), atol=1e-12
    )


def test_split_gmres_solves_the_complex_system():
    """REAL f64 GMRES on the real-equivalent system + split CSL cycle
    reproduces the complex-path solve (the split production form)."""
    n, kh2 = 64, 0.25
    op_c = gt.helmholtz_operator(n, kh2)
    op_s = gt.helmholtz_split_operator(n, kh2)
    # smooth manufactured solution (the documented CSL win config,
    # tests/test_complex.py; a rough random field stalls BOTH layouts
    # identically at ~1e-6 — layout parity, not a split defect)
    x_true = (1.0 + 0.5j) * jnp.ones((n, n), dtype=jnp.complex128)
    b_c = op_c(x_true)
    b_s = gt.complex_to_split(b_c)
    m_s = csl_multigrid_preconditioner(n, kh2, layout="split")
    # restart 2m: the real-equivalent Krylov space needs twice the
    # dimension per complex mode, and RESTART TRUNCATION is what hurts
    # (measured at m=60: 43 restarts vs the complex path's 2; at
    # m=120: 3 restarts / ~2.7x the complex total iterations — the
    # standard real-equivalent price)
    res = gt.gmres(op_s, b_s, restart=120, tol=1e-8, M=m_s,
                   variant="mgsr", certify="true", compute_v_err=False,
                   max_restarts=50)
    assert bool(res.converged)
    x = gt.split_to_complex(res.x)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               atol=1e-6)
    # iteration parity with the complex path (same math, real layout)
    m_c = csl_multigrid_preconditioner(n, kh2)
    res_c = gt.gmres(op_c, b_c, restart=60, tol=1e-8, M=m_c,
                     variant="mgsr", certify="true",
                     compute_v_err=False, max_restarts=50)
    tot_s = max(int(res.restarts) - 1, 0) * 120 + int(res.iterations)
    tot_c = max(int(res_c.restarts) - 1, 0) * 60 + int(res_c.iterations)
    assert tot_s <= 4 * tot_c  # the measured ~2.7x real-equivalent cost


def test_split_sharded_parity():
    """(2, N, N) stack row-sharded on the GRID axis (component axis
    replicated): iteration parity with the replicated run."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gmres_tpu.parallel.mesh import solver_mesh

    n, kh2 = 64, 0.25
    op_s = gt.helmholtz_split_operator(n, kh2)
    x_true = (1.0 + 0.5j) * jnp.ones((n, n), dtype=jnp.complex128)
    b_s = gt.complex_to_split(gt.helmholtz_operator(n, kh2)(x_true))
    m_s = csl_multigrid_preconditioner(n, kh2, layout="split")
    rep = gt.gmres(op_s, b_s, restart=60, tol=1e-9, M=m_s,
                   variant="mgsr", compute_v_err=False, max_restarts=50)
    mesh = solver_mesh(8)
    b_sh = jax.device_put(
        b_s, NamedSharding(mesh, P(None, "grid", None))
    )
    sh = jax.jit(
        lambda bb: gt.gmres(op_s, bb, restart=60, tol=1e-9, M=m_s,
                            variant="mgsr", compute_v_err=False,
                            max_restarts=50)
    )(b_sh)
    assert int(sh.iterations) == int(rep.iterations)
    assert int(sh.restarts) == int(rep.restarts)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(rep.x),
                               atol=1e-10)
