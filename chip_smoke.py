#!/usr/bin/env python
"""Quickest proof that the library's main path runs on the GPU.

    python chip_smoke.py          # one GPU: device, kernel, solve phases
    python chip_smoke.py --four   # four GPUs: the row-sharded solves only

One process drives the card(s). Every phase prints one JSON object; the
last line is the contract line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

printed only when every phase passed. Without a GPU the script exits
non-zero before printing anything to stdout; it never runs on the CPU.

Phases (one GPU):

* device — ``jax.devices()`` and the card's name and power limit from
  ``nvidia-smi`` (a subprocess that stays off JAX).
* kernel — the fused smoother kernel (``gmres_tpu/ops/smoother.py``)
  compiled at every V-cycle level size of the 300² and 4096²
  hierarchies, compared with the plain jnp recurrence in f32, with its
  ``memory_analysis()`` and the time of one application of each.
* solve — multigrid-preconditioned Householder GMRES-IR
  (``inner_dtype=float32``, restart 10, ``certify="true"``, tol 1e-8)
  at 300² and 4096², and the reference configuration at 300² (f64,
  order-2 Chebyshev on (0.2, 8.2), m=50) against the plain C++ or NumPy
  baseline's inner-iteration count. Each true residual is recomputed
  outside the solver with the plain f64 stencil.

``--four``: GSPMD-sharded f64 MG-preconditioned CG and the shard_map +
ppermute halo CG on a 4-device row mesh at 4096², each against the
same solve on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

import gmres_tpu as gt
from gmres_tpu.utils.cache import configure_compilation_cache

TOL = 1e-8
HEADLINE_SIZES = (300, 4096)
KERNEL_WIDTHS = (4096, 2048, 300, 150, 75, 16)
# Relative ∞-norm error of the f32 kernel against the f32 jnp
# recurrence: both round every sweep, in a different order of adds.
KERNEL_TOL = {3: 1e-5, 32: 1e-4}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require_gpu(devices) -> None:
    """Refuse anything but a GPU device list: this script never runs
    its phases on the CPU."""
    if not devices or devices[0].platform != "gpu":
        kinds = sorted({d.platform for d in devices})
        raise SystemExit(f"chip_smoke: no GPU found (JAX devices: {kinds})")


def nvidia_smi() -> str:
    """Name and power limit of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_phase() -> dict:
    devices = jax.devices()
    smi = nvidia_smi()
    print(smi.splitlines()[0], flush=True)
    from gmres_tpu.utils.profiling import hbm_peak_gbps

    return {
        "devices": [str(d) for d in devices],
        "kind": devices[0].device_kind,
        "nvidia_smi": smi.splitlines(),
        "hbm_peak_gbps": hbm_peak_gbps(devices[0]),
    }


def _time(fn, *args, reps: int) -> float:
    """Best wall time of ``reps`` calls, each ended by
    ``block_until_ready`` (compile and warm-up excluded)."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _memory(compiled) -> dict:
    stats = compiled.memory_analysis()
    return {k: int(getattr(stats, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
    ) if hasattr(stats, k)}


def kernel_phase(card: str, widths=KERNEL_WIDTHS, interpret=False) -> dict:
    """The smoother kernel against the jnp recurrence at each width:
    order 3 on [2, 8] (every V-cycle smoother) and order 32 over the
    full spectrum (the coarse solve)."""
    import jax.numpy as jnp

    from gmres_tpu.ops.smoother import (
        chebyshev_k_scalars,
        poly_stencil_smoother,
        smoother_hbm_bytes,
        smoother_plan,
    )
    from gmres_tpu.precond.chebyshev import chebyshev_preconditioner
    from gmres_tpu.ops.stencil import stencil_5pt_apply

    rows, failures = [], []
    for n in widths:
        r = jax.random.normal(jax.random.PRNGKey(n), (n, n), jnp.float32)
        for order, lo in ((3, 2.0), (32, 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2)):
            theta, _, steps = chebyshev_k_scalars(lo, 8.0, order)
            kern = jax.jit(lambda x, t=theta, s=tuple(steps):
                           poly_stencil_smoother(x, t, s,
                                                 interpret=interpret))
            plain = jax.jit(chebyshev_preconditioner(
                stencil_5pt_apply, lo, 8.0, order=order,
                reference_form=False))
            compiled = kern.lower(r).compile()
            z, z_ref = kern(r), plain(r)
            err = float(jnp.max(jnp.abs(z - z_ref))
                        / jnp.max(jnp.abs(z_ref)))
            tol = KERNEL_TOL[order]
            row = {
                "n": n, "order": order, "rel_inf_err": err, "tol": tol,
                "plan": smoother_plan((n, n), order - 1).__dict__,
                "memory_analysis": _memory(compiled),
            }
            if not interpret:
                reps = 20
                row["kernel_s"] = _time(kern, r, reps=reps)
                row["xla_s"] = _time(plain, r, reps=reps)
                row["hbm_bytes_kernel_plain"] = smoother_hbm_bytes(
                    (n, n), order - 1)
                row["card"] = card
            rows.append(row)
            if not err <= tol:
                failures.append((n, order, err))
    if failures:
        raise AssertionError(f"kernel mismatch (n, order, err): {failures}")
    return {"rows": rows}


def true_rel_residual(b, x) -> float:
    """‖b − A·x‖/‖b‖ with the plain f64 jnp stencil (ops/stencil.py),
    outside the solver."""
    import jax.numpy as jnp

    from gmres_tpu.ops.stencil import stencil_5pt_apply

    x = jnp.asarray(x, jnp.float64)
    r = b - stencil_5pt_apply(x)
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b))


def _peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def headline_solve(n: int, card: str, repeats: int) -> dict:
    """MG-preconditioned Householder GMRES-IR at n², timed after
    warm-up."""
    import jax.numpy as jnp

    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n), jnp.float64))
    m_inv = gt.poisson_multigrid_preconditioner(n)
    solve = jax.jit(lambda bb: gt.gmres(
        op, bb, restart=10, tol=TOL, M=m_inv, variant="householder",
        compute_v_err=False, inner_dtype=jnp.float32, certify="true"))
    t_compile = time.perf_counter()
    res = jax.block_until_ready(solve(b))
    t_compile = time.perf_counter() - t_compile
    seconds = _time(solve, b, reps=repeats)
    res = jax.block_until_ready(solve(b))
    true_rel = true_rel_residual(b, res.x)
    out = {
        "config": "mg gmres-ir householder f32-inner restart=10 "
                  "certify=true", "n": n,
        "status": int(res.status), "seconds": seconds,
        "compile_and_first_s": t_compile, "card": card,
        "iterations": int(res.iterations), "restarts": int(res.restarts),
        "total_inner": (int(res.restarts) - 1) * 10 + int(res.iterations),
        "certified_residual": float(res.residual),
        "true_rel_residual": true_rel, "peak_bytes_in_use": _peak_bytes(),
        "levels": m_inv.levels,
    }
    if out["status"] != 0 or not true_rel <= TOL:
        raise AssertionError(f"headline solve failed: {out}")
    return out


def baseline_inner(n: int, m: int) -> tuple:
    """(inner iterations, kind) of the plain f64 baseline in the same
    certify-true mode: the C++ build when g++ works, else NumPy."""
    import jax.numpy as jnp

    b = np.asarray(gt.poisson_operator(n)(jnp.ones((n, n), jnp.float64)))
    try:
        from native import loader

        _, inner, _, _ = loader.hh_gmres(
            n, b.reshape(-1), m=m, tol=TOL, threads=os.cpu_count(),
            certify_true=True)
        return inner, "c++/openmp (native/krylov_ref.cpp)"
    except Exception as e:  # pragma: no cover - host without g++
        print(f"# native baseline unavailable ({e}); numpy", file=sys.stderr)
        from bench import numpy_hh_gmres

        _, inner, _ = numpy_hh_gmres(n, m, TOL, certify_true=True)
        return inner, "numpy (bench.py:numpy_hh_gmres)"


def reference_solve(n: int, card: str) -> dict:
    """The reference driver's configuration (test_poisson_mf.f90:38):
    f64, order-2 Chebyshev on (0.2, 8.2), m=50."""
    import jax.numpy as jnp

    m = 50
    op = gt.poisson_operator(n)
    b = op(jnp.ones((n, n), jnp.float64))
    m_inv = gt.chebyshev_preconditioner(op, 0.2, 8.2)
    solve = jax.jit(lambda bb: gt.gmres(
        op, bb, restart=m, tol=TOL, M=m_inv, variant="householder",
        compute_v_err=False, certify="true"))
    seconds = _time(solve, b, reps=1)
    res = jax.block_until_ready(solve(b))
    inner = (int(res.restarts) - 1) * m + int(res.iterations)
    base_inner, base_kind = baseline_inner(n, m)
    true_rel = true_rel_residual(b, res.x)
    out = {
        "config": "reference f64 cheb2(0.2,8.2) m=50 certify=true",
        "n": n, "status": int(res.status), "seconds": seconds,
        "card": card, "total_inner": inner,
        "restarts": int(res.restarts), "baseline_inner": base_inner,
        "baseline": base_kind, "true_rel_residual": true_rel,
        "peak_bytes_in_use": _peak_bytes(),
    }
    if (out["status"] != 0 or not true_rel <= TOL
            or abs(inner - base_inner) > 1):
        raise AssertionError(f"reference solve failed: {out}")
    return out


def four_phase(card: str, n: int = 4096, n_devices: int = 4) -> dict:
    """Row-sharded f64 solves on an n_devices mesh vs one card."""
    import jax.numpy as jnp

    from gmres_tpu.parallel.halo import (
        halo_chebyshev_preconditioner,
        halo_poisson_operator,
    )
    from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh

    if len(jax.devices()) < n_devices:
        raise AssertionError(
            f"--four needs {n_devices} devices, found {len(jax.devices())}")
    mesh = solver_mesh(n_devices)
    op = gt.poisson_operator(n)
    one = jax.devices()[0]
    b1 = jax.device_put(op(jnp.ones((n, n), jnp.float64)), one)
    bs = shard_grid_vector(b1, mesh)
    tol = TOL * float(jnp.linalg.norm(b1))  # cg's tol is absolute
    max_it = 20 * n

    def sharded_ok(x) -> bool:
        shapes = {s.data.shape for s in x.addressable_shards}
        return shapes == {(n // n_devices, n)}

    cases = {
        "gspmd_mg_cg": (
            (op, gt.poisson_multigrid_preconditioner(n, mesh=mesh)),
            (op, gt.poisson_multigrid_preconditioner(n)),
        ),
        "halo_cheb2_cg": (
            (halo_poisson_operator(mesh),
             halo_chebyshev_preconditioner(mesh, 0.2, 8.2)),
            (op, gt.chebyshev_preconditioner(op, 0.2, 8.2)),
        ),
    }
    rows, failures = [], []
    for name, ((op4, m4), (op1, m1)) in cases.items():
        row = {"case": name, "n": n, "card": card}
        for tag, (o, mm, bb) in (("four", (op4, m4, bs)),
                                 ("one", (op1, m1, b1))):
            solve = jax.jit(lambda v, o=o, mm=mm: gt.cg(
                o, v, tol=tol, max_iterations=max_it, M=mm))
            seconds = _time(solve, bb, reps=1)
            res = jax.block_until_ready(solve(bb))
            row[tag] = {
                "status": int(res.status), "iterations": int(res.iterations),
                "seconds": seconds,
                "true_rel_residual": true_rel_residual(
                    b1, jax.device_put(res.x, one)),
            }
            if tag == "four":
                row[tag]["rows_sharded"] = sharded_ok(res.x)
                row[tag]["peak_bytes_in_use"] = [
                    (d.memory_stats() or {}).get("peak_bytes_in_use")
                    for d in jax.devices()[:n_devices]]
        rows.append(row)
        f, o = row["four"], row["one"]
        if (f["status"] != 0 or o["status"] != 0
                or abs(f["iterations"] - o["iterations"]) > 1
                or not f["true_rel_residual"] <= TOL
                or not o["true_rel_residual"] <= TOL
                or not f["rows_sharded"]):
            failures.append(name)
    if failures:
        raise AssertionError(f"four-device parity failed: {failures}")
    return {"rows": rows}


def run_phase(name: str, fn, *args, **kwargs) -> bool:
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    except Exception as e:  # reported, and the run exits non-zero
        emit({"phase": name, "ok": False,
              "error": f"{type(e).__name__}: {e}"[:4000]})
        return False
    emit({"phase": name, "ok": True,
          "phase_s": time.perf_counter() - t0, **out})
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded solves and their "
                    "one-card comparisons")
    args = ap.parse_args(argv)

    require_gpu(jax.devices())
    configure_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    card = nvidia_smi().splitlines()[0]

    ok = run_phase("device", device_phase)
    if args.four:
        ok &= run_phase("four", four_phase, card)
    else:
        ok &= run_phase("kernel", kernel_phase, card)
        for n in HEADLINE_SIZES:
            ok &= run_phase(f"solve_mg_{n}", headline_solve, n, card,
                            repeats=3 if n < 1000 else 2)
        ok &= run_phase("solve_reference_300", reference_solve, 300, card)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    d = jax.devices()
    emit({"ok": True, "device": {"platform": d[0].platform,
                                 "kind": d[0].device_kind,
                                 "count": len(d)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
