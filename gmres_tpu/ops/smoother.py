"""Fused polynomial stencil smoother: k sweeps of a 5-point stencil
recurrence in one kernel launch (Pallas through Triton).

Every multigrid smoother, the coarse-grid Chebyshev solve and the deep
Chebyshev preconditioner apply the same d-recurrence

    z₀ = d₀ = r/θ ;  dⱼ₊₁ = aⱼ·dⱼ + bⱼ·(r − A·zⱼ) ;  zⱼ₊₁ = zⱼ + dⱼ₊₁

with host-side scalars: ``chebyshev_k_scalars`` gives the Chebyshev
semi-iteration on [λ_min, λ_max], ``jacobi_k_scalars`` damped Jacobi.
XLA compiles the plain form (``precond/chebyshev.py``) to one fused
kernel per sweep inside a ``lax.scan``: each sweep reads z, d and r and
writes z and d, and each scan step is a separate launch. On the small
coarse levels the launches dominate; on the fine level the memory
traffic does. This kernel loads r once, keeps z and d on chip across
the sweeps, and writes z once.

Two plans, chosen by ``smoother_plan`` from the grid shape:

* **Whole grid** (padded side ≤ 128): one program holds the grid and
  runs every sweep in one launch, whatever the order.
* **Tiled** (larger grids): square tiles of side B (a power of two)
  overlap by a halo of H rows and columns on each side. A launch runs
  H sweeps: the zero fill at a tile's edge corrupts one more ring per
  sweep, so after H sweeps the tile's interior (B − 2H)² is exact and
  only it is written (trapezoidal tiling). Deeper orders run several
  launches that carry (z, d) between them. A fixed number of
  persistent programs walk the tiles, so the scratch buffer stays small
  enough for L2.

Neighbour values come from a per-program scratch buffer in global
memory (an extra output; Triton has no scratch operands): each sweep
stores z, synchronises the block, reads the four shifted views, and
synchronises again before the next store. Grid cells outside the
domain are masked to zero in every sweep, which is the Dirichlet
truncation of ``ops/stencil.py:stencil_5pt_general``.

Reference: ``src/preconds/chebyshev.f90:8-38`` is the order-2 member of
this family; the general recurrence is Saad, "Iterative Methods",
alg. 12.1.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

LAPLACE_COEFS = (4.0, -1.0, -1.0, -1.0, -1.0)
USE_PALLAS = ("auto", "never", "interpret")

# Largest padded grid side that one program keeps whole (3 f32 arrays of
# 128² stay in the registers of 16 warps).
WHOLE_GRID_MAX = 128
# Sweeps per launch on tiled grids; also the halo width.
MAX_SWEEPS_PER_LAUNCH = 8
# H100 SXM (NVIDIA data sheet): streaming multiprocessors and L2 cache.
SMS = 132
L2_BYTES = 50 * 2**20
# Persistent programs for tiled grids: at most ~8 per SM.
PROGRAMS = 1024


def chebyshev_k_scalars(lam_min: float, lam_max: float, order: int):
    """(θ, δ, [a₀, b₀, a₁, b₁, …]) of the order-k Chebyshev
    semi-iteration on [lam_min, lam_max] (bounds in either order)."""
    lo, hi = sorted((float(lam_min), float(lam_max)))
    theta = (hi + lo) / 2.0
    delta = (hi - lo) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    steps = []
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        steps.extend([rho_new * rho, 2.0 * rho_new / delta])
        rho = rho_new
    return theta, delta, steps


def jacobi_k_scalars(omega: float, center: float, order: int):
    """(θ, steps) expressing ``order`` damped-Jacobi sweeps
    e ← e + (ω/c₀)·(r − A·e), e₀ = (ω/c₀)·r, in the d-recurrence form:
    θ = c₀/ω and (a, b) = (0, ω/c₀) at every step. The nonsymmetric
    multigrid smoothers use it (real-axis Chebyshev diverges on the
    convection operator's complex spectrum)."""
    step = float(omega) / float(center)
    steps = []
    for _ in range(order - 1):
        steps.extend([0.0, step])
    return 1.0 / step, steps


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SmootherPlan:
    """How ``poly_stencil_smoother`` lays one application out."""

    block: int        # tile side B, a power of two
    halo: int         # overlap H on each side (0: whole grid)
    sweeps: int       # sweeps per launch
    launches: int     # kernel launches per application
    tiles: tuple      # (tiles along rows, tiles along columns)
    programs: int     # persistent programs per launch
    num_warps: int

    @property
    def whole_grid(self) -> bool:
        return self.halo == 0

    @property
    def interior(self) -> int:
        return self.block - 2 * self.halo

    @property
    def scratch_side(self) -> int:
        # z at offset (1, 1); the shifted read of the interior needs
        # B + H + 1 rows and columns.
        return self.block + max(self.halo, 1) + 1

    @property
    def register_bytes(self) -> int:
        """On-chip working set of one program: r, z and d tiles."""
        return 3 * self.block * self.block * 4

    @property
    def scratch_bytes(self) -> int:
        return self.programs * self.scratch_side ** 2 * 4


def smoother_plan(shape, nsweeps: int) -> SmootherPlan:
    """Whole-grid or tiled plan for ``nsweeps`` ≥ 1 sweeps on an f32
    grid of ``shape``."""
    n0, n1 = shape
    if nsweeps < 1:
        raise ValueError("a plan needs at least one sweep")
    side = max(_next_pow2(max(n0, n1)), 16)
    if side <= WHOLE_GRID_MAX:
        return SmootherPlan(
            block=side, halo=0, sweeps=nsweeps, launches=1, tiles=(1, 1),
            programs=1, num_warps=max(4, min(16, side * side // 1024)),
        )
    s = min(nsweeps, MAX_SWEEPS_PER_LAUNCH)

    def tiles_for(block):
        inner = block - 2 * s
        return (-(-n0 // inner), -(-n1 // inner))

    def count(block):
        t = tiles_for(block)
        return t[0] * t[1]

    # 64² tiles; 32² for shallow launches where 64² tiles would leave
    # SMs idle (fewer tiles than SMs). Measured on an H100: 128² tiles
    # (one program per SM for want of registers) ran the order-32
    # smoother 1.4× (4096²) and 2.5× (2048²) slower than 64² tiles.
    block = 32 if s <= 4 and count(64) < SMS else 64
    tiles = tiles_for(block)
    # Persistent programs: at most PROGRAMS, and few enough that their
    # scratch takes at most half of L2.
    side = block + s + 1
    fit = (L2_BYTES // 2) // (side * side * 4)
    return SmootherPlan(
        block=block, halo=s, sweeps=s, launches=-(-nsweeps // s),
        tiles=tiles, programs=min(tiles[0] * tiles[1], PROGRAMS, fit),
        num_warps=4,
    )


def _ds(start: int, size: int):
    # An int32 start: the interpreter materialises static starts in the
    # default int type, which must match the int32 program id.
    return pl.ds(jnp.int32(start), size)


def _smoother_kernel(*refs, plan: SmootherPlan, shape, first: bool,
                     emit_d: bool, interpret: bool):
    if first:
        r_ref, c_ref, *outs = refs
    else:
        r_ref, z_ref, d_ref, c_ref, *outs = refs
    if emit_d:
        z_out, d_out, scr = outs
    else:
        (z_out, scr), d_out = outs, None
    B, H, I = plan.block, plan.halo, plan.interior
    n0, n1 = shape
    ntiles = plan.tiles[0] * plan.tiles[1]
    pid = pl.program_id(0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)
    c0, cw, ce, cs, cn = (c_ref[1], c_ref[2], c_ref[3], c_ref[4],
                          c_ref[5])

    def barrier():
        # The interpreter runs a block's operations in order, and the
        # barrier primitive has no interpret rule.
        if not interpret:
            plgpu.debug_barrier()

    def put_scratch(v):
        plgpu.store(scr.at[pid, _ds(1, B), _ds(1, B)], v)

    def neighbour(dr, dc, mask):
        return plgpu.load(
            scr.at[pid, _ds(1 + dr, B), _ds(1 + dc, B)],
            mask=mask, other=0.0,
        )

    def emit(out, v, t_r, t_c):
        if H == 0:
            plgpu.store(out.at[pl.ds(0, B), pl.ds(0, B)], v,
                        mask=(ii < n0) & (jj < n1))
            return
        # Shift the exact interior to the tile origin through the
        # scratch buffer (register tensors cannot be sliced).
        barrier()
        put_scratch(v)
        barrier()
        inner = (ii < I) & (jj < I)
        v_int = plgpu.load(
            scr.at[pid, _ds(1 + H, B), _ds(1 + H, B)],
            mask=inner, other=0.0,
        )
        plgpu.store(
            out.at[pl.ds(t_r * I, B), pl.ds(t_c * I, B)], v_int,
            mask=inner & (t_r * I + ii < n0) & (t_c * I + jj < n1),
        )

    def tile_body(t, carry):
        # Persistent programs walk the tiles; the clamp makes a surplus
        # program redo the last tile, writing identical values.
        tile = jnp.minimum(pid + t * plan.programs, ntiles - 1)
        t_r = tile // plan.tiles[1]
        t_c = tile % plan.tiles[1]
        g_r = t_r * I - H + ii
        g_c = t_c * I - H + jj
        in_grid = (g_r >= 0) & (g_r < n0) & (g_c >= 0) & (g_c < n1)
        idx = (jnp.clip(g_r, 0, n0 - 1), jnp.clip(g_c, 0, n1 - 1))

        def grid_load(ref):
            return plgpu.load(ref.at[idx], mask=in_grid, other=0.0)

        r = grid_load(r_ref)
        if first:
            d = r / c_ref[0]
            z = d
        else:
            z, d = grid_load(z_ref), grid_load(d_ref)

        def sweep(j, zd):
            z, d = zd
            barrier()
            put_scratch(z)
            barrier()
            az = (c0 * z
                  + cw * neighbour(0, -1, jj > 0)
                  + ce * neighbour(0, 1, jj < B - 1)
                  + cs * neighbour(-1, 0, ii > 0)
                  + cn * neighbour(1, 0, ii < B - 1))
            d = c_ref[6 + 2 * j] * d + c_ref[7 + 2 * j] * (r - az)
            d = jnp.where(in_grid, d, 0.0)
            return z + d, d

        z, d = jax.lax.fori_loop(0, plan.sweeps, sweep, (z, d))
        emit(z_out, z, t_r, t_c)
        if emit_d:
            emit(d_out, d, t_r, t_c)
        return carry

    per_program = -(-ntiles // plan.programs)
    jax.lax.fori_loop(0, per_program, tile_body, 0)


def _launch(plan, shape, first, emit_d, interpret, *args):
    side = plan.scratch_side
    grid_out = jax.ShapeDtypeStruct(shape, jnp.float32)
    out_shape = [grid_out] * (2 if emit_d else 1) + [
        jax.ShapeDtypeStruct((plan.programs, side, side), jnp.float32)
    ]
    kernel = functools.partial(
        _smoother_kernel, plan=plan, shape=shape, first=first,
        emit_d=emit_d, interpret=interpret,
    )
    # Traced with x64 off: index arithmetic stays int32 throughout.
    with jax.enable_x64(False):
        outs = pl.pallas_call(
            kernel,
            grid=(plan.programs,),
            out_shape=tuple(out_shape),
            backend="triton",
            compiler_params=plgpu.CompilerParams(
                num_warps=plan.num_warps, num_stages=1),
            interpret=interpret,
            name="poly_stencil_smoother",
        )(*args)
    return outs[:-1]


@functools.partial(
    jax.jit, static_argnames=("theta", "steps", "coefs", "interpret")
)
def poly_stencil_smoother(
    r: jnp.ndarray,
    theta: float,
    steps: tuple,
    coefs=LAPLACE_COEFS,
    interpret: bool = False,
) -> jnp.ndarray:
    """z ≈ A⁻¹r by the order-k polynomial recurrence above on an f32
    (n0, n1) grid, A the 5-point stencil with ``coefs`` = (center, W,
    E, S, N) and Dirichlet zeros outside the grid. ``steps`` is the
    flat [a₀, b₀, …] of ``chebyshev_k_scalars``/``jacobi_k_scalars``.
    ``interpret=True`` runs the Pallas interpreter (CPU tests)."""
    if r.dtype != jnp.float32 or r.ndim != 2:
        raise ValueError(f"f32 2-D grid required, got {r.dtype} {r.shape}")
    nsweeps = len(steps) // 2
    if nsweeps == 0:
        return r / jnp.float32(theta)
    shape = tuple(r.shape)
    plan = smoother_plan(shape, nsweeps)
    s = plan.sweeps
    # A short last launch runs (a, b) = (0, 0) sweeps, which leave z.
    padded = list(steps) + [0.0] * (2 * s * plan.launches - len(steps))
    chunks = np.asarray(padded, dtype=np.float64).reshape(plan.launches,
                                                          2 * s)
    head = [float(theta), *map(float, coefs)]
    coef = np.asarray([head + list(ch) for ch in chunks], np.float32)
    if plan.launches == 1:
        (z,) = _launch(plan, shape, True, False, interpret, r,
                       jnp.asarray(coef[0]))
        return z
    z, d = _launch(plan, shape, True, True, interpret, r,
                   jnp.asarray(coef[0]))

    def launch(zd, c):
        return tuple(_launch(plan, shape, False, True, interpret, r,
                             *zd, c)), None

    (z, _), _ = jax.lax.scan(launch, (z, d), jnp.asarray(coef[1:]))
    return z


def kernel_mode(x, use_pallas: str) -> str | None:
    """Which smoother route an application takes: None (the plain jnp
    recurrence), "compiled" or "interpret".

    use_pallas: "auto" takes the compiled kernel for f32 2-D grids on a
    single-GPU runtime (on several devices the operand may be
    GSPMD-sharded, and a pallas_call would gather it onto one card);
    "never" keeps jnp; "interpret" runs the kernel in the Pallas
    interpreter wherever it is (CPU tests)."""
    if use_pallas not in USE_PALLAS:
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    if use_pallas == "never" or x.dtype != jnp.float32 or x.ndim != 2:
        return None
    if use_pallas == "interpret":
        return "interpret"
    if jax.default_backend() == "gpu" and jax.device_count() == 1:
        return "compiled"
    return None


def smoother_hbm_bytes(shape, nsweeps: int) -> tuple:
    """(kernel, plain) device-memory bytes of one application: the
    kernel reads r (and z, d after the first launch) per launch with the
    tile overlap, and writes z (and d); the plain scan reads z, d, r and
    writes z, d per sweep. Used to read kernel times against the
    roofline."""
    n = shape[0] * shape[1] * 4
    plan = smoother_plan(shape, nsweeps)
    overlap = (plan.block / plan.interior) ** 2 if plan.halo else 1.0
    first = n * overlap + n * (1 if plan.launches == 1 else 2)
    rest = (plan.launches - 1) * (3 * n * overlap + 2 * n)
    return int(first + rest), int(5 * n * nsweeps)
