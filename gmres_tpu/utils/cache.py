"""One rule for JAX's persistent compilation cache, shared by every
entry point (``bench.py``, ``chip_smoke.py``, ``benchmarks/cli.py`` and
the test suite).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it from the
environment and nothing here sets another directory. Otherwise the
cache goes to the fixed ``<repo>/.jaxcache`` (listed in
``.gitignore``): the path is part of each entry's key, so a directory
that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jaxcache",
)


def configure_compilation_cache() -> str:
    """Apply the rule above; return the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return REPO_CACHE
