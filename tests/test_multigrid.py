"""Geometric multigrid V-cycle preconditioner: grid-independent
iteration counts, intergrid transfer properties, solver integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.precond.multigrid import (
    poisson_multigrid_preconditioner,
    prolong_repeat,
    restrict_sum,
)


def test_restrict_prolong_shapes_and_adjointness():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((16, 16)))
    y = jnp.asarray(rng.standard_normal((8, 8)))
    rx = restrict_sum(x)
    py = prolong_repeat(y)
    assert rx.shape == (8, 8)
    assert py.shape == (16, 16)
    # <R x, y> = <x, P y>: the pair is exactly adjoint (sum vs repeat).
    np.testing.assert_allclose(
        float(jnp.sum(rx * y)), float(jnp.sum(x * py)), rtol=1e-13
    )


def test_restrict_sum_values():
    x = jnp.arange(16.0).reshape(4, 4)
    r = restrict_sum(x)
    assert float(r[0, 0]) == 0 + 1 + 4 + 5


@pytest.mark.parametrize("n", [64, 128])
def test_mg_pcg_grid_independent_iterations(n):
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    m_inv = poisson_multigrid_preconditioner(n)
    res = gt.cg(op, b, tol=1e-9, max_iterations=100, M=m_inv)
    assert bool(res.converged)
    assert int(res.iterations) <= 15  # O(1) in N — the point of MG
    np.testing.assert_allclose(res.x, 1.0, atol=1e-7)


def test_mg_gmres_true_residual():
    n = 128
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    m_inv = poisson_multigrid_preconditioner(n)
    res = gt.gmres(op, b, restart=10, tol=1e-8, M=m_inv,
                   certify="true", compute_v_err=False, max_restarts=50)
    assert bool(res.converged)
    assert float(res.residual) <= 1e-8


def test_mg_mixed_precision():
    n = 64
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    m_inv = poisson_multigrid_preconditioner(n)
    res = gt.gmres(op, b, restart=10, tol=1e-8, M=m_inv,
                   inner_dtype=jnp.float32, certify="true",
                   compute_v_err=False, max_restarts=50)
    assert bool(res.converged)


def test_mg_odd_coarsening_stops():
    """300 → 150 → 75 (odd): auto depth stops there."""
    m_inv = poisson_multigrid_preconditioner(300)
    r = jnp.ones((300, 300))
    z = m_inv(r)
    assert z.shape == (300, 300)
    assert bool(jnp.all(jnp.isfinite(z)))


def test_mg_invalid_levels_raise():
    with pytest.raises(ValueError, match="divisible"):
        poisson_multigrid_preconditioner(30, levels=4)


def test_mg_sharded_parity():
    from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

    mesh = solver_mesh(8)
    n = 64
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    m_inv = poisson_multigrid_preconditioner(n, levels=2)
    plain = gt.cg(op, b, tol=1e-9, max_iterations=100, M=m_inv)
    sharded = jax.jit(
        lambda v: gt.cg(op, v, tol=1e-9, max_iterations=100, M=m_inv)
    )(shard_grid_vector(b, mesh))
    assert int(plain.iterations) == int(sharded.iterations)


@pytest.mark.parametrize("levels", [4, 5])
def test_mg_full_depth_sharded_parity(levels):
    """Full-depth V-cycle under the 8-way mesh: the coarsest grid
    (8×8 at levels=4, 4×4 at levels=5) holds FEWER rows than the mesh
    has devices — GSPMD must reshard the reshape-based transfers and
    still reproduce the unsharded iteration count exactly."""
    from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

    mesh = solver_mesh(8)
    n = 64
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n)))
    m_inv = poisson_multigrid_preconditioner(n, levels=levels)
    f = jax.jit(
        lambda v: gt.gmres(op, v, restart=10, tol=1e-10, M=m_inv,
                           compute_v_err=False)
    )
    plain = f(b)
    sharded = f(shard_grid_vector(b, mesh))
    assert int(plain.iterations) == int(sharded.iterations)
    assert int(plain.restarts) == int(sharded.restarts)
    assert np.max(np.abs(np.asarray(sharded.x) - 1.0)) < 1e-8


def test_replicated_coarse_parity_and_cost():
    """Coarse-level agglomeration (mesh= + replicate_below): the
    replicated cycle is numerically identical to the plain one, and
    the compiled SPMD program carries halo collective-permutes ONLY in
    the fine (still-sharded) level's smoother loops — the coarse
    solve's 31-step Chebyshev scan becomes communication-free."""
    import re

    from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

    mesh = solver_mesh(8)
    n = 64
    b = gt.poisson_apply(jnp.ones((n, n)))
    b_sh = shard_grid_vector(b, mesh)

    mi_plain = poisson_multigrid_preconditioner(n, levels=4)
    mi_repl = poisson_multigrid_preconditioner(n, levels=4, mesh=mesh)

    # numerics: one V-cycle application, bit-comparable
    y_plain = mi_plain(b)
    y_repl = jax.jit(mi_repl)(b_sh)
    np.testing.assert_allclose(
        np.asarray(y_repl), np.asarray(y_plain), rtol=1e-13, atol=1e-13
    )

    def permute_loop_count(mi):
        txt = jax.jit(mi).lower(b_sh).compile().as_text()
        loops = 0
        for comp in re.split(r"\n\n", txt):
            lines = comp.strip().splitlines()
            if not lines or "region" not in lines[0]:
                continue
            if re.search(r" collective-permute", comp):
                loops += 1
        return loops

    n_plain = permute_loop_count(mi_plain)
    n_repl = permute_loop_count(mi_repl)
    # plain: every level's smoother scans communicate (7 loop bodies at
    # levels=4); replicated: only the finest level's (2 bodies).
    assert n_repl < n_plain, (n_repl, n_plain)
    assert n_repl <= 2, n_repl


def test_mg_fine_equiv_sweeps_attribute():
    """The static work count used by bench.py's nnz/s derivation:
    exact value for the default 300-grid configuration
    (pre=post=3 → 2 applies each, +2 residuals = 6 per level, coarse
    order 32 → 31 applies at 1/16 weight: 6·(1+1/4) + 31/16 = 9.4375)."""
    m = poisson_multigrid_preconditioner(300)
    assert m.levels == 3
    assert abs(m.fine_equiv_sweeps - 9.4375) < 1e-12


class TestConvDiffMG:
    def _problem(self, n=64, gx=0.4, gy=0.2):
        op = gt.convection_diffusion_operator(n, gx, gy)
        return op, op(jnp.ones((n, n)))

    def test_bicgstab_iteration_collapse(self):
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 64
        op, b = self._problem(n)
        plain = gt.bicgstab(op, b, tol=1e-9, max_iterations=20000)
        m_inv = convection_diffusion_multigrid_preconditioner(n)
        res = gt.bicgstab(op, b, tol=1e-9, max_iterations=1000, M=m_inv)
        assert bool(res.converged)
        assert int(res.iterations) <= int(plain.iterations) // 5
        np.testing.assert_allclose(res.x, 1.0, atol=1e-6)

    def test_gmres_true_residual(self):
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 64
        op, b = self._problem(n)
        m_inv = convection_diffusion_multigrid_preconditioner(n)
        res = gt.gmres(op, b, restart=15, tol=1e-8, M=m_inv,
                       certify="true", compute_v_err=False,
                       max_restarts=50)
        assert bool(res.converged)
        assert float(res.residual) <= 1e-8

    def test_sharded_agglomerated_parity(self):
        """convdiff cycle with mesh= agglomeration: numerically
        identical to the plain cycle, solver iteration parity under
        the 8-way mesh."""
        from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        mesh = solver_mesh(8)
        n = 64
        op, b = self._problem(n)
        mi_p = convection_diffusion_multigrid_preconditioner(n)
        mi_r = convection_diffusion_multigrid_preconditioner(n, mesh=mesh)
        y_p = mi_p(b)
        y_r = jax.jit(mi_r)(shard_grid_vector(b, mesh))
        np.testing.assert_allclose(np.asarray(y_r), np.asarray(y_p),
                                   rtol=1e-13, atol=1e-13)
        r_p = gt.bicgstab(op, b, tol=1e-9, max_iterations=1000, M=mi_p)
        r_r = jax.jit(
            lambda v: gt.bicgstab(op, v, tol=1e-9, max_iterations=1000,
                                  M=mi_r)
        )(shard_grid_vector(b, mesh))
        assert int(r_p.iterations) == int(r_r.iterations)

    def test_high_peclet_upwind_coarsening_continues(self):
        """Convection-dominated levels rediscretize UPWIND instead of
        stopping the hierarchy (round 2 stopped at |2γ| ≥ 1, leaving a
        2-level cycle whose weak coarse solve caused a 1024²
        BiCGSTAB attainable-accuracy failure)."""
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 64
        op, b = self._problem(n, gx=0.8, gy=0.5)
        m_inv = convection_diffusion_multigrid_preconditioner(
            n, gamma_x=0.8, gamma_y=0.5
        )
        # fine level central; every level after the first γ-doubling
        # (|γ| ≥ 0.9) is upwind; the hierarchy reaches the 16-row floor
        assert m_inv.levels == 3
        assert m_inv.level_schemes == ["central", "upwind", "upwind"]
        res = gt.bicgstab(op, b, tol=1e-9, max_iterations=1000, M=m_inv)
        assert bool(res.converged)

    def test_upwind_coefs_m_matrix(self):
        """Upwind rediscretization is an M-matrix at ANY cell Péclet:
        positive diagonal, non-positive off-diagonals, zero row sums —
        and reduces to the central stencil at γ = 0."""
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_coefs,
            convection_diffusion_coefs_upwind,
        )

        for gx, gy in [(0.0, 0.0), (0.4, 0.2), (3.2, 1.6),
                       (-2.0, 0.5), (12.8, -6.4)]:
            c = convection_diffusion_coefs_upwind(gx, gy)
            assert c[0] > 0
            assert all(cc <= 0 for cc in c[1:])
            assert abs(sum(c)) < 1e-12, c
        assert convection_diffusion_coefs_upwind(0.0, 0.0) == \
            convection_diffusion_coefs(0.0, 0.0)

    def test_deep_cycle_fixes_512_drift(self):
        """Regression for the round-2 artifact: at 512² the 2-level
        cycle left BiCGSTAB with l2_error 2.8e-5 against the
        manufactured solution despite a converged recurrence
        (attainable-accuracy drift). The deep upwind hierarchy keeps
        the preconditioned system well-conditioned enough that the
        certified TRUE residual meets tol. 256² here for test time."""
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 256
        op, b = self._problem(n)
        m_inv = convection_diffusion_multigrid_preconditioner(n)
        assert m_inv.levels == 5
        res = jax.jit(
            lambda bb: gt.bicgstab(op, bb, tol=1e-9,
                                   max_iterations=200, M=m_inv)
        )(b)
        assert bool(res.converged)
        # res.residual is the CERTIFIED true residual (solvers/bicgstab.py)
        assert float(res.residual) < 1e-9
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)

    def test_internal_dtype_f32_cycle(self):
        """internal_dtype=float32 runs the cycle in f32 inside an f64
        solve: still converges to the f64 tolerance (the preconditioner
        is an approximation; precision inside it only affects the
        contraction), output dtype matches the input."""
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 64
        op, b = self._problem(n)
        mi_64 = convection_diffusion_multigrid_preconditioner(n)
        mi_32 = convection_diffusion_multigrid_preconditioner(
            n, internal_dtype=jnp.float32
        )
        z = mi_32(b)
        assert z.dtype == b.dtype
        np.testing.assert_allclose(
            np.asarray(z), np.asarray(mi_64(b)), rtol=1e-4, atol=1e-4
        )
        r64 = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=mi_64)
        r32 = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=mi_32)
        assert bool(r32.converged)
        assert float(r32.residual) < 1e-9
        # f32 rounding inside M costs at most a few extra iterations
        assert int(r32.iterations) <= int(r64.iterations) + 5


class TestNonsymmetricSmoothing:
    """Pins the measured smoother-stability facts the convdiff cycle's
    design rests on (precond/multigrid.py docstring): error-propagation
    spectral radius ρ(I − S·A) on the dense 32² assembly."""

    n = 32

    def _smoother_matrix(self, m_inv):
        n = self.n
        op = lambda v: m_inv(v.reshape(n, n)).reshape(-1)  # noqa: E731
        return np.asarray(
            jax.vmap(op, in_axes=1, out_axes=1)(jnp.eye(n * n))
        )

    def _rho(self, m_inv, gx, gy):
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_matrix,
        )

        a = np.asarray(convection_diffusion_matrix(self.n, gx, gy))
        g = np.eye(self.n ** 2) - self._smoother_matrix(m_inv) @ a
        return float(np.abs(np.linalg.eigvals(g)).max())

    def _jacobi(self, coefs, omega=0.7, steps=3):
        from gmres_tpu.ops.stencil import stencil_5pt_general

        def m_inv(r):
            e = (omega / coefs[0]) * r
            for _ in range(steps - 1):
                e = e + (omega / coefs[0]) * (
                    r - stencil_5pt_general(e, *coefs)
                )
            return e

        return m_inv

    def test_chebyshev_diverges_jacobi_converges_at_doubled_peclet(self):
        """γ = (2.0, 1.0) — the γ-doubled spectrum of a (1.0, 0.5)
        level: real-axis Chebyshev smoothing DIVERGES on the complex
        spectrum on BOTH candidate bands (measured ρ = 1.22 on [2, 8],
        2.31 on [1, 8]) while damped Jacobi contracts at 0.53. The
        reason the convdiff cycle smooths with damped Jacobi, not the
        Poisson cycle's Chebyshev."""
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_coefs,
        )
        from gmres_tpu.ops.stencil import stencil_5pt_general
        from gmres_tpu.precond.chebyshev import chebyshev_preconditioner

        gx, gy = 2.0, 1.0
        cf = convection_diffusion_coefs(gx, gy)
        op = lambda x: stencil_5pt_general(x, *cf)  # noqa: E731
        for lo in (1.0, 2.0):
            cheb = chebyshev_preconditioner(op, lo, 8.0, order=3,
                                            reference_form=False)
            assert self._rho(cheb, gx, gy) > 1.0, lo
        assert self._rho(self._jacobi(cf), gx, gy) < 0.6

    def test_upwind_rescues_jacobi_beyond_peclet_one(self):
        """γ = (3.2, 1.6): CENTRAL differences are no M-matrix and even
        damped Jacobi diverges (ρ = 3.5 measured) — coarsening must
        rediscretize. With the UPWIND stencil at the same γ the
        smoother contracts again; this is the measurement behind
        convection_diffusion_coefs_upwind."""
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_coefs,
            convection_diffusion_coefs_upwind,
        )
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_matrix,
        )

        gx, gy = 3.2, 1.6
        cf_c = convection_diffusion_coefs(gx, gy)
        assert self._rho(self._jacobi(cf_c), gx, gy) > 1.0
        # upwind: ρ(I − S·A_upwind) with A the UPWIND assembly (the
        # smoother and the level operator are the same discretization)
        cf_u = convection_diffusion_coefs_upwind(gx, gy)
        c0, cw, ce, cs, cn = cf_u
        n = self.n
        eye = np.eye(n)
        kx = (c0 / 2.0 * np.eye(n) + cw * np.eye(n, k=-1)
              + ce * np.eye(n, k=1))
        ky = (c0 / 2.0 * np.eye(n) + cs * np.eye(n, k=-1)
              + cn * np.eye(n, k=1))
        a_up = np.kron(eye, kx) + np.kron(ky, eye)
        s = self._smoother_matrix(self._jacobi(cf_u))
        g = np.eye(n * n) - s @ a_up
        assert float(np.abs(np.linalg.eigvals(g)).max()) < 1.0

    def test_auto_omega_estimation(self):
        """omega='auto' Arnoldi-estimates per-level damping
        (solvers/lanczos.py:estimate_jacobi_omega): sane values, and
        the preconditioned solve is at least as good as the hand-tuned
        default."""
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 128
        op = gt.convection_diffusion_operator(n, 0.4, 0.2)
        b = op(jnp.ones((n, n)))
        m_auto = convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, omega="auto"
        )
        assert all(0.3 <= w <= 1.2 for w in m_auto.omegas)
        m_hand = convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
        r_auto = gt.bicgstab(op, b, tol=1e-9, max_iterations=200,
                             M=m_auto)
        r_hand = gt.bicgstab(op, b, tol=1e-9, max_iterations=200,
                             M=m_hand)
        assert bool(r_auto.converged)
        assert int(r_auto.iterations) <= int(r_hand.iterations) + 2


class TestArnoldiEstimation:
    def test_ritz_values_poisson_match_eigh(self):
        """On the SYMMETRIC Poisson operator the Arnoldi Ritz values
        are real and the extremes agree with Lanczos."""
        from gmres_tpu.solvers.lanczos import (
            arnoldi_ritz_values,
            lanczos_bounds,
        )

        n = 32
        op = gt.poisson_operator(n)
        probe = jax.random.normal(jax.random.PRNGKey(0), (n, n),
                                  dtype=jnp.float64)
        ritz = arnoldi_ritz_values(op, probe, steps=20)
        assert float(np.abs(ritz.imag).max()) < 1e-8
        # lanczos_bounds widens hi by the Ritz-pair residual; compare
        # against the raw extremes within that widening's scale
        lo, hi = lanczos_bounds(op, probe, steps=20, rigorous=False)
        np.testing.assert_allclose(ritz.real.max(), float(hi),
                                   rtol=2e-2)
        np.testing.assert_allclose(ritz.real.min(), float(lo),
                                   rtol=2e-2)

    def test_ritz_values_convdiff_complex(self):
        """Convection adds the ±2γ·sin band: nonzero imaginary parts,
        real parts inside the diffusion range (0, 8)."""
        from gmres_tpu.solvers.lanczos import arnoldi_ritz_values

        n = 64
        op = gt.convection_diffusion_operator(n, 0.4, 0.2)
        probe = jax.random.normal(jax.random.PRNGKey(0), (n, n),
                                  dtype=jnp.float64)
        ritz = arnoldi_ritz_values(op, probe, steps=16)
        assert float(np.abs(ritz.imag).max()) > 0.05
        assert 0.0 < ritz.real.min() and ritz.real.max() < 8.0


class TestEllipseChebyshevSmoothing:
    def test_ellipse_interval_real_spectrum(self):
        """b = 0 (real spectrum): the ellipse degenerates to the plain
        high-frequency band [re_max/band, re_max] (up to safeties)."""
        from gmres_tpu.solvers.lanczos import chebyshev_ellipse_interval

        ritz = np.linspace(0.1, 8.0, 30) + 0j
        lo, hi = chebyshev_ellipse_interval(ritz, band=4.0,
                                            im_safety=1.0,
                                            re_safety=1.0)
        assert hi == pytest.approx(8.0)
        assert lo == pytest.approx(2.0)

    def test_ellipse_interval_taller_than_wide_is_none(self):
        from gmres_tpu.solvers.lanczos import chebyshev_ellipse_interval

        ritz = np.array([4 + 3j, 4 - 3j, 5 + 2.8j, 5 - 2.8j, 3.9])
        assert chebyshev_ellipse_interval(ritz, band=4.0) is None

    def test_auto_smoother_beats_jacobi(self):
        """smoother='auto' selects ellipse-Chebyshev on every level of
        the γ=(0.4,0.2) hierarchy (upwind keeps b/a ≤ 0.7) and costs
        fewer-or-equal Krylov iterations than damped Jacobi."""
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        n = 128
        op = gt.convection_diffusion_operator(n, 0.4, 0.2)
        b = op(jnp.ones((n, n)))
        m_c = convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="auto"
        )
        assert all(s == "chebyshev" for s in m_c.smoothers)
        r_c = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=m_c)
        m_j = convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
        r_j = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=m_j)
        assert bool(r_c.converged)
        assert float(r_c.residual) < 1e-9
        assert int(r_c.iterations) <= int(r_j.iterations)

    def test_chebyshev_smoother_infeasible_raises(self):
        """central-only hierarchy at γ=(2,1): every level's smoothing
        band is taller than wide (the divergence regime pinned above) —
        smoother='chebyshev' must refuse rather than diverge."""
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        with pytest.raises(ValueError, match="infeasible"):
            convection_diffusion_multigrid_preconditioner(
                64, 2.0, 1.0, central_gamma_max=100.0,
                smoother="chebyshev",
            )

    def test_auto_smoother_sharded_parity(self):
        from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh
        from gmres_tpu.precond.multigrid import (
            convection_diffusion_multigrid_preconditioner,
        )

        mesh = solver_mesh(8)
        n = 64
        op = gt.convection_diffusion_operator(n, 0.4, 0.2)
        b = op(jnp.ones((n, n)))
        mi_p = convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="auto"
        )
        mi_r = convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="auto", mesh=mesh
        )
        r_p = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=mi_p)
        r_r = jax.jit(
            lambda v: gt.bicgstab(op, v, tol=1e-9, max_iterations=200,
                                  M=mi_r)
        )(shard_grid_vector(b, mesh))
        assert int(r_p.iterations) == int(r_r.iterations)
        assert bool(r_r.converged)


class TestRBGSSmoothing:
    """Red-black Gauss-Seidel smoother (smoother="rbgs"): pins the
    measured ρ(I − S·A) facts behind the per-level safety rule, and
    exercises the cycle end-to-end (see the rbgs bullets in
    convection_diffusion_multigrid_preconditioner's docstring)."""

    n = 32

    def _smoother_matrix(self, m_inv):
        n = self.n
        op = lambda v: m_inv(v.reshape(n, n)).reshape(-1)  # noqa: E731
        return np.asarray(
            jax.vmap(op, in_axes=1, out_axes=1)(jnp.eye(n * n))
        )

    def _rbgs(self, coefs, sweeps=1):
        from gmres_tpu.ops.stencil import stencil_5pt_general

        def m_inv(r):
            ii = jax.lax.broadcasted_iota(jnp.int32, r.shape, 0)
            jj = jax.lax.broadcasted_iota(jnp.int32, r.shape, 1)
            red = ((ii + jj) % 2) == 0

            def half(e, mask):
                resid = r - stencil_5pt_general(e, *coefs)
                return e + jnp.where(mask, resid / coefs[0], 0.0)

            e = half(jnp.where(red, r / coefs[0], 0.0), ~red)
            for _ in range(sweeps - 1):
                e = half(half(e, red), ~red)
            return e

        return m_inv

    def _jacobi(self, coefs, omega=0.7, steps=3):
        from gmres_tpu.ops.stencil import stencil_5pt_general

        def m_inv(r):
            e = (omega / coefs[0]) * r
            for _ in range(steps - 1):
                e = e + (omega / coefs[0]) * (
                    r - stencil_5pt_general(e, *coefs)
                )
            return e

        return m_inv

    def _dense(self, coefs):
        from gmres_tpu.ops.stencil import stencil_5pt_general

        n = self.n
        op = lambda v: stencil_5pt_general(  # noqa: E731
            v.reshape(n, n), *coefs
        ).reshape(-1)
        return np.asarray(
            jax.vmap(op, in_axes=1, out_axes=1)(jnp.eye(n * n))
        )

    def _rho(self, m_inv, a):
        g = np.eye(self.n ** 2) - self._smoother_matrix(m_inv) @ a
        return float(np.abs(np.linalg.eigvals(g)).max())

    def test_rbgs_beats_jacobi_on_m_matrix_levels(self):
        """Equal stencil applications on the γ=(2,1) UPWIND level:
        1-sweep rbgs (2 applies) 0.62 vs 2-step Jacobi 0.73; 2-sweep
        rbgs (4 applies) 0.39 vs even 3-step Jacobi 0.62."""
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_coefs_upwind,
        )

        cf = convection_diffusion_coefs_upwind(2.0, 1.0)
        a = self._dense(cf)
        r_gs1 = self._rho(self._rbgs(cf, 1), a)
        r_j2 = self._rho(self._jacobi(cf, steps=2), a)
        r_gs2 = self._rho(self._rbgs(cf, 2), a)
        r_j3 = self._rho(self._jacobi(cf, steps=3), a)
        assert r_gs1 < r_j2 < 1.0
        assert r_gs2 < r_j3 < 1.0
        assert r_gs2 < 0.45  # measured 0.39

    def test_rbgs_diverges_on_convection_dominated_central(self):
        """γ=(2,1) CENTRAL (non-M-matrix): rbgs ρ = 1.13 > 1 while
        damped Jacobi contracts (0.67) — the measurement behind the
        per-level fallback rule."""
        from gmres_tpu.models.convection_diffusion import (
            convection_diffusion_coefs,
        )

        cf = convection_diffusion_coefs(2.0, 1.0)
        a = self._dense(cf)
        assert self._rho(self._rbgs(cf, 1), a) > 1.0
        assert self._rho(self._jacobi(cf, steps=2), a) < 1.0

    def test_rbgs_cycle_converges_and_labels_levels(self):
        n = 128
        op = gt.convection_diffusion_operator(n, 0.4, 0.2)
        b = op(jnp.ones((n, n)))
        m_gs = gt.convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="rbgs"
        )
        # level 0 is central at γ=(0.4,0.2) < threshold → rbgs-safe;
        # deeper levels are upwind → always rbgs.
        assert all(s == "rbgs" for s in m_gs.smoothers)
        r_gs = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=m_gs)
        assert bool(r_gs.converged)
        assert float(jnp.max(jnp.abs(r_gs.x - 1.0))) < 1e-6
        m_j = gt.convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2
        )
        r_j = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=m_j)
        assert int(r_gs.iterations) <= int(r_j.iterations)

    def test_rbgs_falls_back_on_unsafe_central_fine_level(self):
        """User-level γ=(1, 0.5): the fine level is a CENTRAL operator
        above the Péclet threshold (0.9) — rbgs mode must smooth it
        with damped Jacobi (the γ=(2,1) divergence pinned above) while
        the upwind coarse levels keep rbgs. (At γ=(2,1) itself BOTH
        smoother modes fail end-to-end at 64² — the cycle's central
        fine level is simply a poor preconditioner there — so the
        end-to-end check lives at the moderate super-threshold γ.)"""
        m = gt.convection_diffusion_multigrid_preconditioner(
            64, 1.0, 0.5, smoother="rbgs"
        )
        assert m.smoothers[0] == "jacobi"
        assert all(s == "rbgs" for s in m.smoothers[1:])
        op = gt.convection_diffusion_operator(64, 1.0, 0.5)
        b = op(jnp.ones((64, 64)))
        r = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=m)
        assert bool(r.converged)
        m_j = gt.convection_diffusion_multigrid_preconditioner(
            64, 1.0, 0.5
        )
        r_j = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=m_j)
        assert int(r.iterations) <= int(r_j.iterations)

    def test_rbgs_sharded_parity(self):
        from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

        mesh = solver_mesh(8)
        n = 64
        op = gt.convection_diffusion_operator(n, 0.4, 0.2)
        b = op(jnp.ones((n, n)))
        mi_p = gt.convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="rbgs"
        )
        mi_r = gt.convection_diffusion_multigrid_preconditioner(
            n, 0.4, 0.2, smoother="rbgs", mesh=mesh
        )
        r_p = gt.bicgstab(op, b, tol=1e-9, max_iterations=200, M=mi_p)
        r_r = jax.jit(
            lambda v: gt.bicgstab(op, v, tol=1e-9, max_iterations=200,
                                  M=mi_r)
        )(shard_grid_vector(b, mesh))
        assert int(r_p.iterations) == int(r_r.iterations)
        assert bool(r_r.converged)


class TestTransposedCycle:
    """transpose=True must build the EXACT adjoint of the default
    cycle: assemble both densely at 32² (2 levels, asymmetric 2/3
    smoothing to exercise the pre/post swap) and compare Mᵀ to M.T."""

    n = 32

    def _dense(self, m_inv):
        n = self.n
        op = lambda v: m_inv(v.reshape(n, n)).reshape(-1)  # noqa: E731
        return np.asarray(
            jax.vmap(op, in_axes=1, out_axes=1)(jnp.eye(n * n))
        )

    @pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
    def test_transpose_is_exact_dense(self, smoother):
        kw = dict(gamma_x=0.8, gamma_y=0.4, pre_smooth=2,
                  post_smooth=3, coarse_iters=16, smoother=smoother)
        m = gt.convection_diffusion_multigrid_preconditioner(
            self.n, **kw
        )
        mt = gt.convection_diffusion_multigrid_preconditioner(
            self.n, transpose=True, **kw
        )
        md, mtd = self._dense(m), self._dense(mt)
        np.testing.assert_allclose(mtd, md.T, atol=1e-13)
        # and it is genuinely nonsymmetric (the test has teeth)
        assert np.abs(md - md.T).max() > 1e-6
