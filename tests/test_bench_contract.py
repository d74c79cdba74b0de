"""Driver contract: bench.py must print exactly one JSON line with the
required keys (the round harness records it as BENCH_r{N}.json)."""

import json
import os
import subprocess
import sys


def test_bench_json_contract():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "bench.py", "--nsize", "32", "--skip-baseline",
         "--repeats", "1"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    json_lines = [
        l for l in out.stdout.strip().splitlines()
        if l.startswith("{")
    ]
    assert len(json_lines) == 1
    d = json.loads(json_lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "converged",
                "true_rel_residual"):
        assert key in d, key
    assert d["unit"] == "s"
    assert d["converged"] is True
    assert d["true_rel_residual"] <= 1e-8
    assert d["platform"] == d["device"]["platform"] == "cpu"


def test_bench_refuses_without_gpu():
    """With JAX_PLATFORMS unset and no GPU, bench.py exits non-zero and
    prints no result: a benchmark never falls back to the CPU."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "bench.py", "--nsize", "32", "--skip-baseline",
         "--repeats", "1"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
    )
    if out.returncode == 0:
        import json as _json

        line = _json.loads(out.stdout.strip().splitlines()[-1])
        assert line["device"]["platform"] == "gpu"  # a card is present
        return
    assert not any(l.startswith("{") for l in out.stdout.splitlines())
