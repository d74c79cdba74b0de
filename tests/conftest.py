"""Test configuration: CPU backend with 8 virtual devices (the
fake-multi-device harness the reference lacks — SURVEY §4), float64 on
(the reference is real(8) throughout with tolerances to 1e-15).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The CPU unless JAX_PLATFORMS asks for more (the gpu-marked tests run
# on the card with JAX_PLATFORMS=cuda).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (gmres_tpu/utils/cache.py): the suite's
# wall time is dominated by XLA compiles, and a full-suite run was
# twice observed to wedge INSIDE one specific large GSPMD compile
# (test_lsqr sharded parity) only after ~150 earlier compilations in
# the same process — a cache hit sidesteps the recompile entirely.
from gmres_tpu.utils.cache import configure_compilation_cache  # noqa: E402

configure_compilation_cache()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_client_state():
    """Drop live executables/tracing caches between test MODULES.

    Full-suite runs in ONE process were observed to wedge or segfault
    inside XLA (a compile that never returns at test_lsqr, later a
    SIGSEGV deserializing a cache entry at test_implicit) only after
    ~150 accumulated compilations — never in short runs of the same
    tests. Bounding the in-process client state per module avoids the
    pathological regime; the persistent disk cache above keeps the
    recompiles cheap."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at test
    time, never at import or collection (xdist workers must collect the
    same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/ (chip_smoke.py covers the same path)")
