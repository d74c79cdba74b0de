"""Geometric multigrid V-cycle preconditioner for the 5-point stencil.

Beyond the reference (whose only preconditioner is degree-2 Chebyshev,
chebyshev.f90:8-38): a deep Chebyshev polynomial needs O(√(λmax/λmin))
stencil sweeps to reach the lowest modes — O(N) sweeps on an N×N grid —
while a multigrid V-cycle handles every frequency at the level where it
is local, costing O(1) sweeps per level and ~4/3 of one fine-grid pass
in total traffic. For the 16.8M-variable 4096² benchmark this replaces
an order-256 polynomial per Krylov iteration.

Construction — every ingredient is communication-free or
stencil-local, so the whole cycle shards like the operator itself:

* Operators: the SAME unit 5-point stencil (4, −1, −1, −1, −1) at every
  level. With the h²-scaled convention (A = h²Δ, h folded out), the
  consistent intergrid pair is **restriction = 2×2 block SUM** (the
  (2h)²/h² Jacobian absorbed) and **prolongation = 2×2 replication** —
  pure reshape/broadcast, no gathers, no collectives beyond what the
  stencil itself needs.
* Smoothers: Chebyshev on the upper spectrum [λmax/4, λmax] — dot-free
  (Jacobi-type smoothing would need no dots either, but Chebyshev's
  optimal damping halves the smoothing sweeps). No reductions anywhere
  in the V-cycle ⇒ as a preconditioner it adds ZERO all-reduce points
  to the Krylov loop.
* The cycle is a fixed linear operator (all smoothers are fixed
  polynomials), so it is a legal left preconditioner for GMRES, and
  symmetric enough in practice for CG on the Poisson problem.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from gmres_tpu.ops.stencil import stencil_5pt_apply
from gmres_tpu.precond.chebyshev import chebyshev_preconditioner


def restrict_sum(x: jnp.ndarray) -> jnp.ndarray:
    """(2m, 2m) → (m, m) by 2×2 block SUM (residual transfer for
    h²-scaled operators: the value average times the area factor 4).

    Implemented as strided slices, NOT reshape(m,2,m,2).sum: the
    reshape form once hit a pathological XLA layout path at 4096² that
    dominated the whole V-cycle. Bitwise-identical results."""
    y = x[0::2, :] + x[1::2, :]
    return y[:, 0::2] + y[:, 1::2]


def prolong_repeat(x: jnp.ndarray) -> jnp.ndarray:
    """(m, m) → (2m, 2m) by replication (value-preserving error
    transfer, the adjoint pairing of restrict_sum up to the factor 4
    already absorbed there). jnp.repeat form — see restrict_sum's
    performance note."""
    return jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1)


def poisson_multigrid_preconditioner(
    nsize: int,
    levels: int | None = None,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    coarse_order: int = 32,
    lam_max: float = 8.0,
    smooth_band: float = 4.0,
    mesh=None,
    replicate_below: int | None = None,
    use_pallas: str = "auto",
) -> Callable:
    """V-cycle preconditioner z ≈ A⁻¹r for the nsize×nsize Poisson
    stencil (A = the unit 5-point stencil at every level).

    levels: coarsening depth; default coarsens while the grid is even
      and > 16. nsize must be divisible by 2^(levels-1).
    pre/post_smooth: Chebyshev smoothing order on [λmax/band, λmax].
    coarse_order: Chebyshev order of the coarsest-level solve over the
      full spectrum of that level's grid.
    mesh + replicate_below: coarse-level agglomeration for distributed
      runs. Plain GSPMD keeps every level row-sharded, so each of the
      coarse solve's ``coarse_order`` stencil sweeps pays a (tiny)
      halo collective-permute — pure interconnect latency for grids holding a
      handful of rows per chip. With a mesh given, any level whose
      grid size drops below ``replicate_below`` (default 8 rows per
      device) is constrained REPLICATED: one small all-gather on the
      way down buys communication-free smoothing at every deeper
      level, and the replicated→sharded hand-back on the way up is a
      local slice (no collective). Iteration counts are unchanged —
      this moves data, not math (verified by
      tests/test_multigrid.py::test_replicated_coarse_parity_and_cost).
    """
    if levels is None:
        levels = 1
        n = nsize
        while n % 2 == 0 and n > 16:
            n //= 2
            levels += 1
    sizes = [nsize // (2 ** l) for l in range(levels)]
    for l, n in enumerate(sizes):
        if l > 0 and sizes[l - 1] != 2 * n:
            raise ValueError(
                f"nsize={nsize} not divisible by 2**{levels - 1}"
            )

    # Smoothers route through chebyshev_stencil_preconditioner: same
    # semi-iteration polynomial, but f32 single-GPU applications take
    # the fused smoother kernel (ops/smoother.py). The distributed
    # (mesh=) cycle stays on the jnp route: a pallas_call would force
    # its sharded operand local.
    from gmres_tpu.precond.chebyshev import (
        chebyshev_stencil_preconditioner,
    )

    import math

    up = "never" if mesh is not None else use_pallas
    smoother = chebyshev_stencil_preconditioner(
        lam_max / smooth_band, lam_max,
        order=max(pre_smooth, 1), use_pallas=up,
    )
    post_smoother = chebyshev_stencil_preconditioner(
        lam_max / smooth_band, lam_max,
        order=max(post_smooth, 1), use_pallas=up,
    )
    # coarsest level's exact λ_min: solve its full spectrum
    lam_min_coarse = 8.0 * math.sin(
        math.pi / (2 * (sizes[-1] + 1))
    ) ** 2
    coarse_solve = chebyshev_stencil_preconditioner(
        lam_min_coarse, lam_max, order=coarse_order, use_pallas=up,
    )

    replicate_from = levels  # first level index to replicate (none)
    apply_at = {l: stencil_5pt_apply for l in range(levels)}
    smoother_at = {l: (smoother, post_smoother) for l in range(levels)}
    coarse_at = coarse_solve
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        n_dev = int(mesh.devices.size)
        if replicate_below is None:
            replicate_below = 8 * n_dev
        for l, sz in enumerate(sizes):
            if sz < replicate_below:
                replicate_from = l
                break
        repl = NamedSharding(mesh, PartitionSpec())

        def pin(x):
            return jax.lax.with_sharding_constraint(x, repl)

        # A single constraint at level entry does NOT survive GSPMD's
        # backward propagation (measured: the coarse scan bodies kept
        # their halo collective-permutes). Pinning the OPERATOR —
        # inputs and outputs of every stencil inside the smoother
        # scans — anchors the whole coarse computation replicated.
        def stencil_repl(x):
            return pin(stencil_5pt_apply(pin(x)))

        repl_smooth = chebyshev_preconditioner(
            stencil_repl, lam_max / smooth_band, lam_max,
            order=max(pre_smooth, 1), reference_form=False,
        )
        repl_post = chebyshev_preconditioner(
            stencil_repl, lam_max / smooth_band, lam_max,
            order=max(post_smooth, 1), reference_form=False,
        )
        repl_coarse = chebyshev_preconditioner(
            stencil_repl, lam_min_coarse, lam_max,
            order=coarse_order, reference_form=False,
        )
        for l in range(replicate_from, levels):
            apply_at[l] = stencil_repl
            smoother_at[l] = (repl_smooth, repl_post)
        if replicate_from <= levels - 1:
            coarse_at = repl_coarse

        def agglomerate(r):
            return pin(r)
    else:
        def agglomerate(r):
            return r

    def v_cycle(r: jnp.ndarray, level: int) -> jnp.ndarray:
        if level == replicate_from:
            r = agglomerate(r)
        if level == levels - 1:
            return coarse_at(r)
        pre_s, post_s = smoother_at[level]
        a_l = apply_at[level]
        e = pre_s(r)
        r2 = r - a_l(e)
        ec = v_cycle(restrict_sum(r2), level + 1)
        e = e + prolong_repeat(ec)
        r3 = r - a_l(e)
        return e + post_s(r3)

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        return v_cycle(r, 0)

    # Exact work accounting for benchmark nnz/s derivation (the cycle
    # is a fixed linear operator, so this is a count of the program's
    # static structure, not an estimate). An order-k Chebyshev
    # semi-iteration applies the operator exactly k−1 times
    # (precond/chebyshev.py scan of order−1 steps); each non-coarsest
    # level adds 2 residual computations; level l's grid carries
    # 4^-l of the fine grid's stencil points.
    per_level = (max(pre_smooth, 1) - 1) + (max(post_smooth, 1) - 1) + 2
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.25 ** l for l in range(levels - 1)
    ) + (coarse_order - 1) * 0.25 ** (levels - 1)
    m_inv.levels = levels
    return m_inv


def convection_diffusion_multigrid_preconditioner(
    nsize: int,
    gamma_x: float = 0.4,
    gamma_y: float = 0.2,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    omega: float = 0.7,
    coarse_iters: int = 64,
    mesh=None,
    replicate_below: int | None = None,
    central_gamma_max: float = 0.9,
    use_pallas: str = "auto",
    internal_dtype=None,
    max_levels: int | None = None,
    smoother: str = "jacobi",
    shift: float = 0.0,
    transpose: bool = False,
) -> Callable:
    """V-cycle preconditioner for the NONSYMMETRIC convection-diffusion
    stencil (models/convection_diffusion.py).

    transpose: build the EXACT transpose Mᵀ of the cycle this
    constructor returns with ``transpose=False`` — the un-fencing of
    the transpose-using solvers (QMR) from the multigrid family, which
    ``jax.linear_transpose`` cannot derive through fori/while smoothing
    loops. The transpose is mechanical because every building block is
    self-adjoint or swaps with its mirror: ``restrict_sum`` and
    ``prolong_repeat`` are mutual adjoints (R = Pᵀ), the Jacobi and
    Chebyshev smoothers are real-scalar polynomials in the level
    operator (transpose = same polynomial in A_lᵀ), the truncated
    constant stencil transposes by swapping W↔E and S↔N, and
    red-black Gauss-Seidel transposes to black-red order. So Mᵀ = the
    same V-cycle over the transposed level stencils with pre/post
    smoother counts swapped and rbgs parity flipped (pinned to the
    dense transpose in ``tests/test_multigrid.py``; QMR integration in
    ``tests/test_qmr.py``).

    shift: zeroth-order term σ — the cycle approximates
    (A_convdiff + σI)⁻¹. Like the shifted-Laplacian cycle's shift
    (helmholtz_shifted_laplacian_preconditioner) it is h²-scaled, so
    it QUADRUPLES per coarsening: level l adds σ·4ˡ to the diagonal
    coefficient. The use case is implicit time stepping on the
    convection-diffusion operator: S = I + θΔt·A = θΔt·(A + σI) with
    σ = 1/(θΔt) — build with ``shift=σ`` and wrap
    ``lambda r: cycle(r)/(θΔt)`` (see theta_evolve's M docs; a shift
    also only ever HELPS the smoothers — more diagonal dominance).

    Differences from the Poisson cycle, all forced by nonsymmetry:

    * **Per-level operators**: the cell-Péclet numbers γ = b·h/2 DOUBLE
      with each 2× coarsening (convection scales with h, diffusion with
      h²), so every level rediscretizes with its own (γx·2ˡ, γy·2ˡ).
    * **Upwind rediscretization on convection-dominated levels**: once
      any |γ·2ˡ| reaches ``central_gamma_max``, central differences go
      oscillatory (non-M-matrix) and both the smoother and the coarse
      correction degrade — round 2 therefore STOPPED coarsening there,
      which left e.g. the 1024² problem with a 2-level cycle whose 512²
      "coarse solve" was 64 Jacobi sweeps: the weak preconditioner
      behind an earlier BiCGSTAB attainable-accuracy failure. Coarse
      levels now
      switch to the first-order upwind stencil
      (``convection_diffusion_coefs_upwind``) — an M-matrix at ANY γ —
      and coarsening continues to ≤16 rows as in the Poisson cycle.
      First-order accuracy is fine for a coarse-grid *correction*; the
      fine level (the operator actually solved) stays central.
    * **Damped-Jacobi smoothing** (e ← e + ω/c₀·(r − A e), c₀ = the
      level's diagonal): real-axis Chebyshev DIVERGES on this
      operator's complex spectrum once |γ| ≈ 2 (measured ρ(I−SA) =
      1.2–2.3 at γ = (2, 1) on both candidate bands;
      tests/test_multigrid.py::TestNonsymmetricSmoothing pins it),
      while damped Jacobi's contraction only needs the symmetric part
      to dominate. Still reduction-free. ``omega="auto"``
      Arnoldi-estimates each level's spectrum and picks the ω
      minimizing the high-frequency contraction bound
      (solvers/lanczos.py:estimate_jacobi_omega) — the C10 estimation
      capability extended beyond SPD; the numeric default 0.7 skips
      the setup matvecs.
    * **smoother="rbgs"**: red-black Gauss-Seidel — checkerboard
      parity masks (broadcasted_iota), so a sweep is two masked
      stencil applications with no reordering or gathers, exactly a
      Gauss-Seidel iteration in red-black ordering. Needs no spectral
      information and beats damped Jacobi at equal stencil
      applications on every M-matrix level (measured 2-sweep ρ = 0.39
      vs 3-step Jacobi 0.62 at γ=(2,1) upwind), but DIVERGES on
      convection-dominated central levels (ρ = 1.13 there) — so it
      auto-falls-back to damped Jacobi per level where the central
      discretization exceeds the Péclet threshold.

    Smoother routing mirrors the Poisson cycle: single-GPU f32
    applications take the fused smoother kernel (the damped-Jacobi
    sweep is the (a, b) = (0, ω/c₀) special case of the same
    d-recurrence — ops/smoother.py:jacobi_k_scalars); residuals,
    f64, CPU and distributed cycles stay on the jnp route.

    internal_dtype: run the WHOLE cycle in this dtype (cast r on entry,
      cast z back on exit). The standard mixed-precision play for an
      f64 outer solver (BiCGSTAB): the preconditioner is an
      approximation anyway, so f32 rounding inside it costs iterations
      only if it changes the cycle's contraction — measured: none at
      these Péclet numbers — while making every smoother
      kernel-routable.

    Measured at 128², γ=(0.4, 0.2): unpreconditioned BiCGSTAB 234
    iterations → 7 with this cycle.
    """
    from gmres_tpu.models.convection_diffusion import (
        convection_diffusion_coefs,
        convection_diffusion_coefs_upwind,
    )
    from gmres_tpu.ops.stencil import stencil_5pt_general

    levels = []
    n, gx, gy = nsize, float(gamma_x), float(gamma_y)
    central = True
    while n % 2 == 0 and n > 16 and (
        max_levels is None or len(levels) < max_levels - 1
    ):
        levels.append((n, gx, gy, central))
        n, gx, gy = n // 2, 2 * gx, 2 * gy
        if max(abs(gx), abs(gy)) >= central_gamma_max:
            central = False
    levels.append((n, gx, gy, central))
    n_levels = len(levels)
    coefs = [
        convection_diffusion_coefs(g_x, g_y) if cen
        else convection_diffusion_coefs_upwind(g_x, g_y)
        for (_, g_x, g_y, cen) in levels
    ]
    if shift:
        # h²-scaled zeroth-order term: quadruples per coarsening
        # (same scaling law as the Helmholtz cycle's shift).
        coefs = [
            (c0 + float(shift) * 4.0 ** l, cw, ce, cs, cn)
            for l, (c0, cw, ce, cs, cn) in enumerate(coefs)
        ]

    rb_parity = 0
    if transpose:
        # (c0,cw,ce,cs,cn) → (c0,ce,cw,cn,cs): the adjoint of the
        # truncated stencil; smoother-count swap and color flip make
        # the whole cycle the exact transpose (see docstring).
        coefs = [
            (c0, ce, cw, cn, cs) for (c0, cw, ce, cs, cn) in coefs
        ]
        pre_smooth, post_smooth = post_smooth, pre_smooth
        rb_parity = 1

    if smoother not in ("jacobi", "chebyshev", "auto", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")

    def _level_ritz():
        # Arnoldi spectrum per level on a ≤64² surrogate grid (the
        # stencil symbol's spectrum is essentially grid-size
        # independent above ~32 rows; the coarsest level's surrogate
        # IS its own size) — a handful of setup-time matvecs, once per
        # preconditioner build.
        import jax as _jax

        from gmres_tpu.solvers.lanczos import arnoldi_ritz_values

        _pdtype = (jnp.float64 if _jax.config.jax_enable_x64
                   else jnp.float32)
        out = []
        for (sz, _, _, _), cf in zip(levels, coefs):
            m_ = min(sz, 64)
            probe = _jax.random.normal(
                _jax.random.PRNGKey(0), (m_, m_), dtype=_pdtype
            )
            out.append(arnoldi_ritz_values(
                lambda x, cf=cf: stencil_5pt_general(x, *cf),
                probe, steps=16,
            ))
        return out

    ritz_list = None
    if omega == "auto" or smoother in ("chebyshev", "auto"):
        ritz_list = _level_ritz()

    if omega == "auto":
        # Per-level damping from the Arnoldi-estimated spectrum
        # (solvers/lanczos.py:estimate_jacobi_omega) instead of the
        # hand-tuned constant.
        import numpy as _np

        omegas = []
        for ritz, cf in zip(ritz_list, coefs):
            re_max = float(_np.max(ritz.real))
            upper = ritz[ritz.real >= re_max / 4.0]
            if upper.size == 0:
                omegas.append(0.7)
                continue
            grid = _np.linspace(0.05, 1.5, 146)
            rho = _np.abs(
                1.0 - _np.outer(grid, upper / cf[0])
            ).max(axis=1)
            omegas.append(float(grid[int(_np.argmin(rho))]))
    else:
        omegas = [float(omega)] * n_levels

    # Ellipse-Chebyshev smoothing intervals (Manteuffel): per level,
    # the real-foci interval equivalent to the smallest enclosing
    # wider-than-tall ellipse of the high-frequency Ritz values; None
    # where no such ellipse exists (taller-than-wide spectrum region)
    # → damped Jacobi for that level. The coarse solve gets a
    # FULL-spectrum interval. Measured (lanczos.py docstring): beats
    # damped Jacobi at every upwind level, 10× at high Péclet.
    cheb_ivals = [None] * n_levels
    coarse_ival = None
    if smoother in ("chebyshev", "auto"):
        from gmres_tpu.solvers.lanczos import chebyshev_ellipse_interval

        cheb_ivals = [
            chebyshev_ellipse_interval(r, band=4.0) for r in ritz_list
        ]
        coarse_ival = chebyshev_ellipse_interval(
            ritz_list[-1], band=None
        )
        if smoother == "chebyshev" and all(
            iv is None for iv in cheb_ivals
        ):
            raise ValueError(
                "smoother='chebyshev' infeasible: every level's "
                "high-frequency spectrum is taller than wide — use "
                "'auto' (per-level fallback to damped Jacobi)"
            )

    # Coarse-level agglomeration, same design (and same GSPMD pinning
    # lesson) as the Poisson cycle above: pin the OPERATOR at
    # replicated levels so the smoothing loops stay communication-free.
    replicate_from = n_levels
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        if replicate_below is None:
            replicate_below = 8 * int(mesh.devices.size)
        for l, (sz, _, _, _) in enumerate(levels):
            if sz < replicate_below:
                replicate_from = l
                break
        _repl = NamedSharding(mesh, PartitionSpec())

        def _pin(x):
            return jax.lax.with_sharding_constraint(x, _repl)
    else:
        def _pin(x):
            return x

    from gmres_tpu.ops.smoother import (
        USE_PALLAS,
        jacobi_k_scalars,
        kernel_mode,
        poly_stencil_smoother,
    )

    if use_pallas not in USE_PALLAS:
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    kernel_ok = use_pallas != "never" and mesh is None

    def apply_l(x, l):
        if l >= replicate_from:
            return _pin(stencil_5pt_general(_pin(x), *coefs[l]))
        return stencil_5pt_general(x, *coefs[l])

    def cheb_apply(r, l, iters, iv):
        from gmres_tpu.precond.chebyshev import (
            chebyshev_stencil_preconditioner,
        )

        lo, hi = iv
        if mesh is not None:
            if l >= replicate_from:
                op_ = lambda x: _pin(  # noqa: E731
                    stencil_5pt_general(_pin(x), *coefs[l])
                )
            else:
                op_ = lambda x: stencil_5pt_general(  # noqa: E731
                    x, *coefs[l]
                )
            return chebyshev_preconditioner(
                op_, lo, hi, order=iters, reference_form=False
            )(r)
        return chebyshev_stencil_preconditioner(
            lo, hi, order=iters, coefs=coefs[l],
            use_pallas=(use_pallas if kernel_ok else "never"),
        )(r)

    def rbgs_smooth(r, l, iters):
        # Red-black Gauss-Seidel: one 4-color-free sweep = red update
        # then black update, each a masked-Jacobi step whose stencil
        # only reads the OTHER color — so a full sweep is an exact
        # Gauss-Seidel iteration in checkerboard ordering, at the cost
        # of 2 stencil applications. Parity masks from
        # broadcasted_iota (elementwise, fused by XLA into the stencil's
        # adds — no gathers, no reordering, shards like the stencil).
        # Smoothing is genuinely stronger than damped Jacobi (Poisson
        # smoothing factor 0.25/sweep vs 0.6; measured on convdiff in
        # tests/test_multigrid.py::TestNonsymmetricSmoothing), and
        # unlike Chebyshev it needs no spectral interval, so it is safe
        # on the complex spectra where real-axis Chebyshev diverges.
        # jnp-only route (the two masked applies fuse).
        import jax

        c0 = coefs[l][0]
        ii = jax.lax.broadcasted_iota(jnp.int32, r.shape, 0)
        jj = jax.lax.broadcasted_iota(jnp.int32, r.shape, 1)
        red = ((ii + jj) % 2) == rb_parity

        def half(e, mask):
            resid = r - apply_l(e, l)
            return e + jnp.where(mask, resid / c0, 0.0)

        def sweep(e):
            return half(half(e, red), ~red)

        # first red half-step from e=0 is just the masked scaled r
        e = half(jnp.where(red, r / c0, 0.0), ~red)
        if iters <= 4:  # short smoothers: unrolled fuses best
            for _ in range(iters - 1):
                e = sweep(e)
            return e
        return jax.lax.fori_loop(
            0, iters - 1, lambda _, ee: sweep(ee), e
        )

    # rbgs is only a contraction where the level's stencil is an
    # M-matrix: upwind levels always, central levels only below the
    # Péclet threshold. Measured at 32² (pinned in
    # tests/test_multigrid.py): γ=(2,1) central rbgs ρ(I−SA) = 1.13
    # (diverges; damped Jacobi 0.67) vs upwind rbgs 0.62; at equal
    # stencil applications rbgs beats Jacobi on every M-matrix level
    # (2 sweeps 0.39 vs 3-step Jacobi 0.62 at γ=(2,1) upwind). So
    # smoother="rbgs" falls back to damped Jacobi per-level on unsafe
    # central levels.
    rbgs_ok = [
        (not cen) or max(abs(g_x), abs(g_y)) < central_gamma_max
        for (_, g_x, g_y, cen) in levels
    ]

    def smooth(r, l, iters):
        import jax

        if smoother == "rbgs" and rbgs_ok[l]:
            return rbgs_smooth(r, l, iters)
        iv = coarse_ival if l == n_levels - 1 else cheb_ivals[l]
        if iv is not None:
            return cheb_apply(r, l, iters, iv)
        step = omegas[l] / coefs[l][0]
        mode = kernel_mode(r, use_pallas) if kernel_ok else None
        if mode is not None and l < replicate_from:
            theta, steps = jacobi_k_scalars(
                omegas[l], coefs[l][0], iters
            )
            return poly_stencil_smoother(
                r, theta, tuple(steps), tuple(coefs[l]),
                interpret=(mode == "interpret"),
            )
        e = step * r
        if iters <= 4:  # short smoothers: unrolled fuses best
            for _ in range(iters - 1):
                e = e + step * (r - apply_l(e, l))
            return e
        # deep coarse solves: fori_loop, or the trace blows up
        # (CLAUDE.md rule 6)
        return jax.lax.fori_loop(
            0, iters - 1,
            lambda _, ee: ee + step * (r - apply_l(ee, l)),
            e,
        )

    def v_cycle(r, l):
        if l == replicate_from:
            r = _pin(r)
        if l == n_levels - 1:
            return smooth(r, l, coarse_iters)
        e = smooth(r, l, pre_smooth)
        rc = restrict_sum(r - apply_l(e, l))
        e = e + prolong_repeat(v_cycle(rc, l + 1))
        return e + smooth(r - apply_l(e, l), l, post_smooth)

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        if internal_dtype is not None and r.dtype != internal_dtype:
            return v_cycle(r.astype(internal_dtype), 0).astype(r.dtype)
        return v_cycle(r, 0)

    m_inv.levels = n_levels
    m_inv.level_schemes = [
        ("central" if cen else "upwind") for (_, _, _, cen) in levels
    ]
    m_inv.omegas = omegas
    m_inv.smoothers = [
        ("rbgs" if rbgs_ok[l] else "jacobi") if smoother == "rbgs"
        else (
            "chebyshev" if (
                (coarse_ival if l == n_levels - 1 else cheb_ivals[l])
                is not None
            ) else "jacobi"
        )
        for l in range(n_levels)
    ]
    m_inv.cheb_intervals = cheb_ivals
    m_inv.coarse_interval = coarse_ival
    return m_inv


def helmholtz_shifted_laplacian_preconditioner(
    nsize: int,
    kh2: float,
    shift: float = 1.0,
    levels: int | None = None,
    smooth_order: int = 3,
    coarse_order: int = 32,
    smooth_band: float = 4.0,
    mesh=None,
    replicate_below: int | None = None,
    use_pallas: str = "auto",
    internal_dtype=None,
) -> Callable:
    """SPD shifted-Laplacian V-cycle for the INDEFINITE Helmholtz
    stencil (models/helmholtz.py): M ≈ (−Δ + shift·k²)⁻¹, the real
    Bayliss-Goldstein-Turkel preconditioner. Multigrid cannot be run
    on −Δ − k² itself (the coarse-grid correction amplifies the
    near-null indefinite modes), but the POSITIVELY shifted operator
    is an M-matrix at every level and multigrid is optimal on it;
    applied to the Helmholtz system it clusters the spectrum into
    [−1, 1] with a gap scaling like 1/(kh)², trading iteration counts
    that grow with the indefiniteness for a fixed O(1)-sweep cycle.

    Structure mirrors ``poisson_multigrid_preconditioner`` (same
    transfers, same per-level Chebyshev smoothing on the upper
    spectrum) with ONE change: the shift is an h²-scaled zeroth-order
    term, so it QUADRUPLES per coarsening — level l's stencil is
    (4 + shift·kh2·4ˡ, −1, −1, −1, −1), and every level's spectral
    interval is known in closed form (Dirichlet eigenvalues of the
    unit stencil, offset by the level shift), so no setup-time
    estimation is needed.

    SYMMETRY: pre- and post-smoothers are the SAME fixed polynomial
    S = p(A_l) in the symmetric level operator and the transfers are
    exact adjoints (restrict_sum = prolong_repeatᵀ), so the whole
    cycle is a symmetric positive-definite operator — the property
    MINRES (solvers/minres.py) requires of its preconditioner. That is
    why this function takes a single ``smooth_order`` instead of the
    pre/post pair its siblings expose. Verified by direct assembly in
    tests/test_minres.py.

    internal_dtype: run the cycle in this dtype (f32 makes every
    smoother Pallas-routable under an f64 outer solver, same play as
    the convection-diffusion cycle above).
    """
    import math

    from gmres_tpu.ops.stencil import stencil_5pt_general
    from gmres_tpu.precond.chebyshev import (
        chebyshev_stencil_preconditioner,
    )

    if shift < 0:
        raise ValueError("shift must be >= 0 (SPD requires +k² shift)")
    if levels is None:
        levels = 1
        n = nsize
        while n % 2 == 0 and n > 16:
            n //= 2
            levels += 1
    sizes = [nsize // (2 ** l) for l in range(levels)]
    for l, n in enumerate(sizes):
        if l > 0 and sizes[l - 1] != 2 * n:
            raise ValueError(
                f"nsize={nsize} not divisible by 2**{levels - 1}"
            )
    shifts = [float(shift) * float(kh2) * 4.0 ** l for l in range(levels)]
    coefs = [(4.0 + s, -1.0, -1.0, -1.0, -1.0) for s in shifts]
    lam_maxs = [8.0 + s for s in shifts]
    # coarsest level's exact λ_min (unit-stencil Dirichlet minimum
    # plus that level's shift): solve its full spectrum.
    lam_min_coarse = shifts[-1] + 8.0 * math.sin(
        math.pi / (2 * (sizes[-1] + 1))
    ) ** 2

    up = "never" if mesh is not None else use_pallas
    smoother_at = {
        l: chebyshev_stencil_preconditioner(
            lam_maxs[l] / smooth_band, lam_maxs[l],
            order=max(smooth_order, 1), coefs=coefs[l], use_pallas=up,
        )
        for l in range(levels)
    }
    coarse_at = chebyshev_stencil_preconditioner(
        lam_min_coarse, lam_maxs[-1],
        order=coarse_order, coefs=coefs[-1], use_pallas=up,
    )

    def _apply_raw(x, l):
        return stencil_5pt_general(x, *coefs[l])

    apply_at = {l: (lambda x, l=l: _apply_raw(x, l)) for l in range(levels)}

    replicate_from = levels
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        if replicate_below is None:
            replicate_below = 8 * int(mesh.devices.size)
        for l, sz in enumerate(sizes):
            if sz < replicate_below:
                replicate_from = l
                break
        repl = NamedSharding(mesh, PartitionSpec())

        def pin(x):
            return jax.lax.with_sharding_constraint(x, repl)

        # Pin the OPERATOR, not just the level entry — the same GSPMD
        # backward-propagation lesson as the cycles above.
        for l in range(replicate_from, levels):
            def stencil_repl(x, l=l):
                return pin(stencil_5pt_general(pin(x), *coefs[l]))

            apply_at[l] = stencil_repl
            smoother_at[l] = chebyshev_preconditioner(
                stencil_repl, lam_maxs[l] / smooth_band, lam_maxs[l],
                order=max(smooth_order, 1), reference_form=False,
            )
        if replicate_from <= levels - 1:
            coarse_at = chebyshev_preconditioner(
                apply_at[levels - 1], lam_min_coarse, lam_maxs[-1],
                order=coarse_order, reference_form=False,
            )

        def agglomerate(r):
            return pin(r)
    else:
        def agglomerate(r):
            return r

    def v_cycle(r: jnp.ndarray, level: int) -> jnp.ndarray:
        if level == replicate_from:
            r = agglomerate(r)
        if level == levels - 1:
            return coarse_at(r)
        s_l = smoother_at[level]
        a_l = apply_at[level]
        e = s_l(r)
        ec = v_cycle(restrict_sum(r - a_l(e)), level + 1)
        e = e + prolong_repeat(ec)
        return e + s_l(r - a_l(e))

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        if internal_dtype is not None and r.dtype != internal_dtype:
            return v_cycle(r.astype(internal_dtype), 0).astype(r.dtype)
        return v_cycle(r, 0)

    # Same static work accounting as the Poisson cycle (for nnz/s
    # derivations): order-k Chebyshev = k−1 operator applications.
    per_level = 2 * (max(smooth_order, 1) - 1) + 2
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.25 ** l for l in range(levels - 1)
    ) + (coarse_order - 1) * 0.25 ** (levels - 1)
    m_inv.levels = levels
    m_inv.level_shifts = shifts
    return m_inv


def restrict_sum3d(x: jnp.ndarray) -> jnp.ndarray:
    """(2m,)³ → (m,)³ by 2×2×2 block sum × 1/2. The ½ is the 3-D
    consistency factor: the h²-scaled operator gains (2h)²/h² = 4 per
    coarsening while a block holds 2³ = 8 cells, so sum-restriction
    must carry 4/8 (in 2-D the two factors coincide and the 2-D
    ``restrict_sum`` is a plain sum). Strided slices, not reshape —
    same XLA pathology as 2-D (restrict_sum docstring)."""
    y = x[0::2] + x[1::2]
    y = y[:, 0::2] + y[:, 1::2]
    return 0.5 * (y[:, :, 0::2] + y[:, :, 1::2])


def prolong_repeat3d(x: jnp.ndarray) -> jnp.ndarray:
    """(m,)³ → (2m,)³ by replication — adjoint of restrict_sum3d up to
    the positive factor already absorbed there (cycle symmetry is
    preserved under a scalar factor on the coarse correction)."""
    return jnp.repeat(
        jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1), 2, axis=2
    )


def poisson3d_multigrid_preconditioner(
    nsize: int,
    levels: int | None = None,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    coarse_order: int = 32,
    smooth_band: float = 4.0,
    mesh=None,
    replicate_below: int | None = None,
) -> Callable:
    """V-cycle preconditioner for the 3-D 7-point Poisson stencil
    (models/poisson3d.py). Same design as the 2-D cycle — per-level
    Chebyshev smoothing on the upper spectrum [λmax/band, λmax] with
    λmax = 12, closed-form coarse λmin, adjoint transfers — with the
    3-D transfer scaling (restrict_sum3d docstring). jnp-only: the
    stencil's axis rolls shard/fuse under XLA; no 3-D Pallas kernel
    yet (the 2-D kernels' trapezoidal tiling does not carry over
    directly).

    No reference counterpart (2-D only, src/problems/poisson.f90)."""
    import math

    from gmres_tpu.ops.stencil import stencil_7pt_apply

    if levels is None:
        levels = 1
        n = nsize
        while n % 2 == 0 and n > 8:
            n //= 2
            levels += 1
    sizes = [nsize // (2 ** l) for l in range(levels)]
    for l, n in enumerate(sizes):
        if l > 0 and sizes[l - 1] != 2 * n:
            raise ValueError(
                f"nsize={nsize} not divisible by 2**{levels - 1}"
            )
    lam_max = 12.0
    lam_min_coarse = 6.0 * (1.0 - math.cos(math.pi / (sizes[-1] + 1)))

    replicate_from = levels
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        if replicate_below is None:
            replicate_below = 8 * int(mesh.devices.size)
        for l, sz in enumerate(sizes):
            if sz < replicate_below:
                replicate_from = l
                break
        repl = NamedSharding(mesh, PartitionSpec())

        def pin(x):
            return jax.lax.with_sharding_constraint(x, repl)
    else:
        def pin(x):
            return x

    def apply_l(x, l):
        if l >= replicate_from:
            return pin(stencil_7pt_apply(pin(x)))
        return stencil_7pt_apply(x)

    smoother_at = {
        l: chebyshev_preconditioner(
            (lambda x, l=l: apply_l(x, l)),
            lam_max / smooth_band, lam_max,
            order=max(pre_smooth, 1), reference_form=False,
        )
        for l in range(levels)
    }
    post_at = {
        l: chebyshev_preconditioner(
            (lambda x, l=l: apply_l(x, l)),
            lam_max / smooth_band, lam_max,
            order=max(post_smooth, 1), reference_form=False,
        )
        for l in range(levels)
    }
    coarse_at = chebyshev_preconditioner(
        (lambda x: apply_l(x, levels - 1)),
        lam_min_coarse, lam_max, order=coarse_order,
        reference_form=False,
    )

    def v_cycle(r, l):
        if l == replicate_from:
            r = pin(r)
        if l == levels - 1:
            return coarse_at(r)
        e = smoother_at[l](r)
        rc = restrict_sum3d(r - apply_l(e, l))
        e = e + prolong_repeat3d(v_cycle(rc, l + 1))
        return e + post_at[l](r - apply_l(e, l))

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        return v_cycle(r, 0)

    per_level = (max(pre_smooth, 1) - 1) + (max(post_smooth, 1) - 1) + 2
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.125 ** l for l in range(levels - 1)
    ) + (coarse_order - 1) * 0.125 ** (levels - 1)
    m_inv.levels = levels
    return m_inv


def csl_multigrid_preconditioner(
    nsize: int,
    kh2: float,
    shift: tuple = (1.0, 0.5),
    levels: int | None = None,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.5,
    coarse_iters: int = 32,
    mesh=None,
    replicate_below: int | None = None,
    layout: str = "complex",
) -> Callable:
    """COMPLEX shifted-Laplacian V-cycle for the Helmholtz stencil:
    M ≈ (−Δ − (β₁ + iβ₂)k²)⁻¹ with shift = (β₁, β₂), the
    Erlangga-Oosterlee-Vuik preconditioner. Where the real +k² shift
    (``helmholtz_shifted_laplacian_preconditioner``) pays a spectral
    cluster radius growing with (kh)², the complex shift keeps the
    preconditioned spectrum inside a circle touching the origin from
    inside for any wavenumber — the standard route to
    wavenumber-robust Helmholtz iteration counts. β₂ trades multigrid
    stability for preconditioner quality: the V-cycle on the shifted
    operator is stable for β₂ ≳ 0.5 (the imaginary shift keeps every
    level's diagonal |4 − (β₁+iβ₂)(kh)²4ˡ| bounded away from zero
    through the indefinite transition band where the REAL-shifted
    hierarchy would lose diagonal dominance).

    Per level l the stencil is (4 − (β₁+iβ₂)·kh2·4ˡ, −1, −1, −1, −1);
    smoothing is damped Jacobi e ← e + ω/c₀·(r − A e) with complex c₀
    (ω-JAC, the smoother of the original CSL papers — Chebyshev
    intervals don't exist for the complex-diagonal levels). Transfers
    are the same adjoint sum/replicate pair. Everything is jnp (the
    smoother kernel is real f32 only).

    Returns a complex-to-complex callable; use with
    ``gmres(..., variant="mgsr")`` (the complex-capable variant) on
    ``helmholtz_operator(n, kh2, damping=...)`` systems.

    layout="split": the SPLIT-COMPLEX form — the same cycle acting on
    the (2, N, N) real re/im stack of
    ``models/helmholtz.py:helmholtz_split_operator``, every complex
    scalar multiply expanded to its 2×2 real rotation, for runtimes
    without a complex datapath: the split cycle is plain f32/f64
    stencils. Exactly equal to
    the complex cycle on CPU (tests/test_helmholtz_split.py pins the
    dense identification).
    """
    import jax

    from gmres_tpu.ops.stencil import stencil_5pt_general

    if layout not in ("complex", "split"):
        raise ValueError(f"unknown layout {layout!r}")
    beta = complex(float(shift[0]), float(shift[1]))
    if levels is None:
        levels = 1
        n = nsize
        while n % 2 == 0 and n > 16:
            n //= 2
            levels += 1
    sizes = [nsize // (2 ** l) for l in range(levels)]
    for l, n in enumerate(sizes):
        if l > 0 and sizes[l - 1] != 2 * n:
            raise ValueError(
                f"nsize={nsize} not divisible by 2**{levels - 1}"
            )
    coefs = [
        (4.0 - beta * float(kh2) * 4.0 ** l, -1.0, -1.0, -1.0, -1.0)
        for l in range(levels)
    ]

    replicate_from = levels
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        if replicate_below is None:
            replicate_below = 8 * int(mesh.devices.size)
        for l, sz in enumerate(sizes):
            if sz < replicate_below:
                replicate_from = l
                break
        repl = NamedSharding(mesh, PartitionSpec())

        def pin(x):
            return jax.lax.with_sharding_constraint(x, repl)
    else:
        def pin(x):
            return x

    if layout == "split":
        # Complex scalar × (2, N, N) stack = the 2×2 real rotation.
        def cmul(c, z):
            zr, zi = z[0], z[1]
            return jnp.stack([
                c.real * zr - c.imag * zi,
                c.imag * zr + c.real * zi,
            ])

        def apply_l_raw(x, l):
            c0 = coefs[l][0]
            nb = jnp.stack([
                stencil_5pt_general(x[0], 0.0, -1.0, -1.0, -1.0, -1.0),
                stencil_5pt_general(x[1], 0.0, -1.0, -1.0, -1.0, -1.0),
            ])
            return cmul(c0, x) + nb

        def scale_step(l, v):
            return cmul(omega / coefs[l][0], v)

        def restrict_(x):
            return jnp.stack(
                [restrict_sum(x[0]), restrict_sum(x[1])]
            )

        def prolong_(x):
            return jnp.stack(
                [prolong_repeat(x[0]), prolong_repeat(x[1])]
            )
    else:
        def apply_l_raw(x, l):
            return stencil_5pt_general(x, *coefs[l])

        def scale_step(l, v):
            return (omega / coefs[l][0]) * v

        restrict_ = restrict_sum
        prolong_ = prolong_repeat

    def apply_l(x, l):
        if l >= replicate_from:
            return pin(apply_l_raw(pin(x), l))
        return apply_l_raw(x, l)

    def smooth(r, l, iters):
        e = scale_step(l, r)
        if iters <= 4:
            for _ in range(iters - 1):
                e = e + scale_step(l, r - apply_l(e, l))
            return e
        return jax.lax.fori_loop(
            0, iters - 1,
            lambda _, ee: ee + scale_step(l, r - apply_l(ee, l)),
            e,
        )

    def v_cycle(r, l):
        if l == replicate_from:
            r = pin(r)
        if l == levels - 1:
            return smooth(r, l, coarse_iters)
        e = smooth(r, l, pre_smooth)
        rc = restrict_(r - apply_l(e, l))
        e = e + prolong_(v_cycle(rc, l + 1))
        return e + smooth(r - apply_l(e, l), l, post_smooth)

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        return v_cycle(r, 0)

    per_level = (pre_smooth - 1) + (post_smooth - 1) + 4
    m_inv.fine_equiv_sweeps = sum(
        per_level * 0.25 ** l for l in range(levels - 1)
    ) + (coarse_iters - 1) * 0.25 ** (levels - 1)
    m_inv.levels = levels
    m_inv.level_coefs = coefs
    return m_inv


def anisotropic_multigrid_preconditioner(
    nsize: int,
    eps: float,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 32,
    min_size: int = 16,
    smoother: str = "line",
) -> Callable:
    """V-cycle for ε·u_xx + u_yy (models/anisotropic.py) with LINE
    relaxation along the strong (last) axis.

    Why line smoothing: at ε ≪ 1 pointwise smoothers leave
    strong-axis-smooth / weak-axis-oscillatory error untouched
    (smoothing factor → 1), so a point-Jacobi cycle's iteration count
    BLOWS UP as ε shrinks — smoother="point" is kept as the
    measurable strawman (tests/test_anisotropic.py pins the
    contrast). Line relaxation solves every strong-axis tridiagonal
    exactly per sweep:

        e ← e + ω T⁻¹ (r − A e),   T = tridiag(−1, 2ε + 2, −1)

    batched over all rows by PCR (ops/tridiag.py) — log₂(n)
    elementwise steps, no gathers, device-local under row sharding
    (lines run along the unsharded lane axis), so the cycle stays
    collective-free like every other V-cycle here.

    Under h²-scaling the (ε, 1) coefficients are level-independent,
    so the Poisson transfer pair (restrict_sum / prolong_repeat)
    carries over unchanged; full coarsening + line smoothing is the
    standard robust pairing for grid-aligned anisotropy (Trottenberg
    et al., Multigrid §5.1).
    """
    from gmres_tpu.models.anisotropic import anisotropic_apply
    from gmres_tpu.ops.tridiag import tridiag_solve_pcr

    if smoother not in ("line", "point"):
        raise ValueError(f"unknown smoother {smoother!r}")

    sizes = [nsize]
    while sizes[-1] % 2 == 0 and sizes[-1] > min_size:
        sizes.append(sizes[-1] // 2)
    n_levels = len(sizes)
    diag = 2.0 * eps + 2.0

    def line_solve(r):
        shp = r.shape
        dl = jnp.full(shp, -1.0, r.dtype)
        dd = jnp.full(shp, diag, r.dtype)
        du = jnp.full(shp, -1.0, r.dtype)
        return tridiag_solve_pcr(dl, dd, du, r)

    def smooth(r, iters):
        # lax.fori_loop, NOT a Python loop: a coarse solve is dozens
        # of sweeps, each containing a log2(n)-step PCR solve —
        # unrolled inside the Krylov while_loop this explodes compile
        # time (CLAUDE.md rule 6; measured: minutes → seconds).
        import jax as _jax

        def sweep(_, e):
            resid = r - anisotropic_apply(e, eps)
            if smoother == "line":
                return e + omega * line_solve(resid)
            return e + (omega / diag) * resid

        return _jax.lax.fori_loop(0, iters, sweep, jnp.zeros_like(r))

    def v_cycle(r, l):
        if l == n_levels - 1:
            return smooth(r, coarse_iters)
        e = smooth(r, pre_smooth)
        resid = r - anisotropic_apply(e, eps)
        e = e + prolong_repeat(v_cycle(restrict_sum(resid), l + 1))
        resid = r - anisotropic_apply(e, eps)
        return e + smooth(resid, post_smooth)

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        return v_cycle(r, 0)

    return m_inv
