"""Fused polynomial smoother kernel (ops/smoother.py, Pallas through
Triton) in interpret mode vs the jnp recurrence, its plan and routing,
and the auto-dispatching stencil preconditioner wrapper. The compiled
kernel runs on the GPU only (``gpu`` marker; covered on the card by
chip_smoke.py's kernel phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.ops.smoother import (
    chebyshev_k_scalars,
    jacobi_k_scalars,
    kernel_mode,
    poly_stencil_smoother,
    smoother_hbm_bytes,
    smoother_plan,
)
from gmres_tpu.precond.chebyshev import chebyshev_stencil_preconditioner


def _cheb_kernel(r, order, lo, hi, coefs=(4.0, -1.0, -1.0, -1.0, -1.0)):
    theta, _, steps = chebyshev_k_scalars(lo, hi, order)
    return poly_stencil_smoother(r, theta, tuple(steps), coefs,
                                 interpret=True)


@pytest.mark.parametrize("order", [2, 4, 16, 64])
def test_chebk_pallas_matches_jnp(order):
    n = 32
    r = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    )
    op = gt.poisson_operator(n)
    z_ref = gt.chebyshev_preconditioner(
        op, 0.005, 8.0, order=order, reference_form=False
    )(r.astype(jnp.float64))
    z = _cheb_kernel(r, order, 0.005, 8.0)
    rel = float(jnp.max(jnp.abs(z - z_ref)) / jnp.max(jnp.abs(z_ref)))
    assert rel < 5e-4


def test_chebk_scalars_shape():
    theta, delta, steps = chebyshev_k_scalars(0.2, 8.2, 8)
    assert theta == pytest.approx(4.2)
    assert delta == pytest.approx(4.0)
    assert len(steps) == 2 * 7


def test_wrapper_f64_route_matches_general_recurrence():
    n = 24
    r = jnp.asarray(np.random.default_rng(1).standard_normal((n, n)))
    m = chebyshev_stencil_preconditioner(0.005, 8.0, order=8)
    z_ref = gt.chebyshev_preconditioner(
        gt.poisson_operator(n), 0.005, 8.0, order=8, reference_form=False
    )(r)
    np.testing.assert_allclose(m(r), z_ref, rtol=1e-12)


def test_wrapper_routes_agree_at_order2():
    """Both wrapper routes (jnp and kernel) apply the SAME polynomial
    at every order — an f32 GPU run must not silently get a different
    preconditioner than an f64 run (the jnp route once used cbpr2's
    closed form at order=2 while the kernel ran the semi-iteration, an
    82% discrepancy)."""
    n = 16
    r32 = jnp.asarray(
        np.random.default_rng(2).standard_normal((n, n)).astype(np.float32)
    )
    m_never = chebyshev_stencil_preconditioner(0.2, 8.2, order=2,
                                               use_pallas="never")
    m_kernel = chebyshev_stencil_preconditioner(0.2, 8.2, order=2,
                                                use_pallas="interpret")
    z_jnp = m_never(r32.astype(jnp.float64))
    z_pal = m_kernel(r32)
    np.testing.assert_allclose(z_pal, z_jnp, rtol=1e-4, atol=1e-6)
    # exact cbpr2 reference parity remains available via
    # chebyshev_preconditioner (reference_form=True default at order 2)
    z_cb = gt.chebyshev_preconditioner(gt.poisson_operator(n), 0.2,
                                       8.2)(r32.astype(jnp.float64))
    assert not np.allclose(z_cb, z_jnp)  # different polynomials, by design


def test_wrapper_drives_gmres():
    n = 48
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    m = chebyshev_stencil_preconditioner(0.005, 8.0, order=16)
    res = gt.gmres(op, b, restart=20, tol=1e-9, M=m,
                   compute_v_err=False)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-6)


@pytest.mark.parametrize("order,n", [(2, 130), (3, 150), (8, 140),
                                     (9, 200)])
def test_chebk_blocked_matches_jnp(order, n):
    """Tiled (trapezoidal) plan: exact vs the jnp recurrence, including
    the per-sweep Dirichlet masking of out-of-grid tile cells, tiles
    that overhang the grid edge, and (order 9) two launches carrying
    (z, d) between them."""
    from gmres_tpu.ops.stencil import stencil_5pt_apply
    from gmres_tpu.precond.chebyshev import chebyshev_preconditioner

    assert not smoother_plan((n, n), order - 1).whole_grid
    rng = np.random.default_rng(30 + order)
    r = jnp.asarray(rng.standard_normal((n, n)), dtype=jnp.float32)
    ref = chebyshev_preconditioner(
        stencil_5pt_apply, 0.5, 8.0, order=order, reference_form=False
    )(r)
    y = _cheb_kernel(r, order, 0.5, 8.0)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                               atol=2e-6)


def test_chebk_blocked_order_too_deep_raises():
    """An order deeper than the tile halo no longer raises: the tiled
    plan splits it into launches of at most 8 sweeps. A non-f32 grid,
    or a plan for no sweep at all, still raises."""
    plan = smoother_plan((256, 256), 39)
    assert plan.halo == plan.sweeps == 8 and plan.launches == 5
    with pytest.raises(ValueError, match="f32"):
        poly_stencil_smoother(jnp.ones((64, 64), jnp.float64), 1.0,
                              (0.0, 1.0), interpret=True)
    with pytest.raises(ValueError, match="sweep"):
        smoother_plan((64, 64), 0)


# ---------------------------------------------------------------------------
# Generalized polynomial smoother (damped Jacobi = the (a, b) = (0, ω/c₀)
# special case of the same d-recurrence — used by the
# convection-diffusion multigrid smoothers).
# ---------------------------------------------------------------------------


def _jacobi_oracle(r, coefs, omega, iters):
    from gmres_tpu.ops.stencil import stencil_5pt_general

    step = omega / coefs[0]
    e = step * r
    for _ in range(iters - 1):
        e = e + step * (r - stencil_5pt_general(e, *coefs))
    return e


@pytest.mark.parametrize("iters", [1, 3, 8])
def test_poly_smoother_jacobi_matches_oracle(iters):
    from gmres_tpu.models.convection_diffusion import (
        convection_diffusion_coefs,
        convection_diffusion_coefs_upwind,
    )

    n = 32
    r = jnp.asarray(
        np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    )
    for coefs in (convection_diffusion_coefs(0.4, 0.2),
                  convection_diffusion_coefs_upwind(1.6, 0.8)):
        theta, steps = jacobi_k_scalars(0.7, coefs[0], iters)
        z = poly_stencil_smoother(
            r, theta, tuple(steps), tuple(coefs), interpret=True
        )
        z_ref = _jacobi_oracle(r.astype(jnp.float64),
                               coefs, 0.7, iters)
        rel = float(jnp.max(jnp.abs(z - z_ref))
                    / jnp.max(jnp.abs(z_ref)))
        assert rel < 5e-5, (coefs, rel)


@pytest.mark.parametrize("iters,n", [(3, 136), (8, 144)])
def test_poly_smoother_blocked_matches_oracle(iters, n):
    from gmres_tpu.models.convection_diffusion import (
        convection_diffusion_coefs,
    )

    r = jnp.asarray(
        np.random.default_rng(2).standard_normal((n, n)).astype(np.float32)
    )
    coefs = convection_diffusion_coefs(0.4, 0.2)
    theta, steps = jacobi_k_scalars(0.7, coefs[0], iters)
    z = poly_stencil_smoother(
        r, theta, tuple(steps), tuple(coefs), interpret=True,
    )
    z_ref = _jacobi_oracle(r.astype(jnp.float64), coefs, 0.7, iters)
    rel = float(jnp.max(jnp.abs(z - z_ref)) / jnp.max(jnp.abs(z_ref)))
    assert rel < 5e-5, rel


def test_poly_smoother_chebyshev_equivalence():
    """The stencil Chebyshev preconditioner's kernel route is the poly
    smoother with the Chebyshev coefficient schedule — same kernel,
    same numbers."""
    n = 32
    r = jnp.asarray(
        np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    )
    theta, _, steps = chebyshev_k_scalars(0.005, 8.0, 8)
    z_poly = poly_stencil_smoother(
        r, theta, tuple(steps), interpret=True
    )
    z_cheb = chebyshev_stencil_preconditioner(
        0.005, 8.0, order=8, use_pallas="interpret")(r)
    np.testing.assert_array_equal(np.asarray(z_poly), np.asarray(z_cheb))


def test_routed_general_stencil_cpu_falls_back():
    """On the CPU, use_pallas="auto" takes the jnp recurrence (the
    kernel is compiled only for a single GPU), f32 included."""
    from gmres_tpu.models.convection_diffusion import (
        convection_diffusion_coefs,
    )
    from gmres_tpu.ops.stencil import stencil_5pt_general

    n = 16
    coefs = convection_diffusion_coefs(0.4, 0.2)
    x = jnp.asarray(
        np.random.default_rng(4).standard_normal((n, n)), jnp.float32
    )
    assert kernel_mode(x, "auto") is None
    m = chebyshev_stencil_preconditioner(2.0, 8.0, order=3, coefs=coefs)
    ref = gt.chebyshev_preconditioner(
        lambda v: stencil_5pt_general(v, *coefs), 2.0, 8.0, order=3,
        reference_form=False)(x)
    np.testing.assert_array_equal(np.asarray(m(x)), np.asarray(ref))


# ---------------------------------------------------------------------------
# The wrapper's plan: power-of-two padding, whole-grid versus tiled, and
# the per-program budgets at the real V-cycle level sizes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(16, 16), (17, 32), (75, 128),
                                     (100, 128), (128, 128)])
def test_plan_whole_grid_pads_to_power_of_two(n, block):
    plan = smoother_plan((n, n), 31)
    assert plan.whole_grid and plan.block == block
    assert plan.launches == 1 and plan.sweeps == 31 and plan.programs == 1


@pytest.mark.parametrize("n", [129, 150, 300, 2048, 4096])
def test_plan_tiled_above_whole_grid_limit(n):
    plan = smoother_plan((n, n), 2)
    assert not plan.whole_grid
    b = plan.block
    assert b & (b - 1) == 0 and plan.halo == 2
    # the tiles' exact interiors cover the grid
    assert plan.tiles[0] * plan.interior >= n
    assert (plan.tiles[0] - 1) * plan.interior < n


@pytest.mark.parametrize("n", [4096, 2048, 300, 150, 75, 16])
@pytest.mark.parametrize("nsweeps", [2, 31, 764])
def test_plan_fits_budgets_at_level_sizes(n, nsweeps):
    """Every plan at the V-cycle level sizes (and the deep Chebyshev's
    order) keeps one program's r, z and d tiles inside an SM's register
    file (65,536 × 4 bytes) and the persistent scratch inside half of
    the 50 MB L2."""
    plan = smoother_plan((n, n), nsweeps)
    assert plan.register_bytes <= 65536 * 4, plan
    assert plan.scratch_bytes <= 25 * 2**20, plan
    assert plan.sweeps * plan.launches >= nsweeps


def test_smoother_hbm_bytes_kernel_below_plain():
    kernel, plain = smoother_hbm_bytes((4096, 4096), 2)
    assert kernel < plain / 2


def test_kernel_mode_routing():
    x32 = jnp.zeros((8, 8), jnp.float32)
    assert kernel_mode(x32, "never") is None
    assert kernel_mode(x32, "interpret") == "interpret"
    assert kernel_mode(x32.astype(jnp.float64), "interpret") is None
    assert kernel_mode(jnp.zeros((8,), jnp.float32), "interpret") is None
    with pytest.raises(ValueError):
        kernel_mode(x32, "always")
    with pytest.raises(ValueError):
        chebyshev_stencil_preconditioner(0.2, 8.2, use_pallas="always")


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_on_gpu(gpu):
    """The compiled kernel at a tiled and a whole-grid size."""
    from gmres_tpu.ops.stencil import stencil_5pt_apply
    from gmres_tpu.precond.chebyshev import chebyshev_preconditioner

    for n, order in ((300, 3), (75, 32)):
        r = jax.random.normal(jax.random.PRNGKey(n), (n, n), jnp.float32)
        theta, _, steps = chebyshev_k_scalars(0.1, 8.0, order)
        z = poly_stencil_smoother(r, theta, tuple(steps))
        ref = chebyshev_preconditioner(stencil_5pt_apply, 0.1, 8.0,
                                       order=order,
                                       reference_form=False)(r)
        rel = float(jnp.max(jnp.abs(z - ref)) / jnp.max(jnp.abs(ref)))
        assert rel <= 1e-4
