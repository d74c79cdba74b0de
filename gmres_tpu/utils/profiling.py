"""Profiling and roofline helpers (SURVEY §5 tracing plan).

The reference's only instrumentation is omp_get_wtime around whole
solves (test_poisson_mf.f90:44-46). Here: jax.profiler trace capture
around any callable, per-phase named scopes (the solvers annotate their
SpMV / orthogonalization / small-matrix phases), and a stencil roofline
measurement against HBM speed-of-light — the BASELINE.json
"speed-of-light" requirement made checkable.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import jax.numpy as jnp

# Published peak device-memory bandwidth (GB/s), keyed by the
# device_kind JAX reports. Source: NVIDIA H100 Tensor Core GPU data
# sheet — H100 SXM5 80 GB HBM3, 3.35 TB/s (at the full 700 W limit).
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def hbm_peak_gbps(device=None) -> float:
    """Published peak bandwidth of ``device`` (default: the first
    device). A device_kind outside ``HBM_PEAK_GBPS`` is an error: a
    fraction of an unknown peak is not a number to report."""
    device = device or jax.devices()[0]
    kind = device.device_kind
    if kind not in HBM_PEAK_GBPS:
        raise KeyError(
            f"no published HBM peak for device_kind {kind!r}; add it to "
            "gmres_tpu/utils/profiling.py:HBM_PEAK_GBPS with its source"
        )
    return HBM_PEAK_GBPS[kind]


def measure_bandwidth(
    fn: Callable, x: jnp.ndarray, bytes_moved: int, reps: int = 50
) -> dict:
    """Achieved effective bandwidth of fn(x) (GB/s), compile excluded.

    Applications are CHAINED inside one jit call (x ← fn(x)) and timed
    at two rep counts, each ended by ``jax.block_until_ready``; the
    per-application time is the SLOPE, so the per-call dispatch cost
    cancels out. Requires fn: X → X where X is an array or a pytree of
    arrays (every stencil/SpMV qualifies). On a GPU the result carries
    the fraction of the published peak; elsewhere it carries none (a
    CPU rate is not a device metric)."""

    def total(k):
        chained = jax.jit(
            lambda v: jax.lax.fori_loop(0, k, lambda _, u: fn(u), v)
        )
        jax.block_until_ready(chained(x))
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(chained(x))
            best = min(best, time.perf_counter() - t0)
        return best

    r1 = max(1, reps)
    r2 = 2 * r1
    dt = max((total(r2) - total(r1)) / (r2 - r1), 1e-9)
    gbps = bytes_moved / dt / 1e9
    device = jax.devices()[0]
    out = {"seconds": dt, "gbps": gbps, "platform": device.platform,
           "device_kind": device.device_kind}
    if device.platform == "gpu":
        peak = hbm_peak_gbps(device)
        out.update(peak_gbps=peak, fraction_of_peak=gbps / peak)
    return out


def stencil_roofline(nsize: int, dtype=jnp.float32, reps: int = 50) -> dict:
    """Roofline check of the 5-point stencil: it reads and writes one
    grid each (ideal traffic 2·N²·itemsize; halo re-reads hit in the
    cache)."""
    from gmres_tpu.ops.stencil import stencil_5pt_apply

    x = jnp.ones((nsize, nsize), dtype=dtype)
    bytes_moved = 2 * x.size * x.dtype.itemsize
    out = measure_bandwidth(stencil_5pt_apply, x, bytes_moved, reps)
    out["kernel"] = "stencil_5pt_jnp"
    out["nsize"] = nsize
    out["dtype"] = str(dtype)
    return out
