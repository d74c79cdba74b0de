"""chip_smoke.py logic that holds without a GPU: it refuses a CPU-only
device list, ``--four`` selects only its phase, the compile-cache rule,
and the HBM peak table's refusal of unknown devices."""

import importlib.util
import os
import subprocess
import sys
import types

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_cpu_device_list():
    cs = _load_chip_smoke()
    with pytest.raises(SystemExit, match="no GPU"):
        cs.require_gpu(jax.devices("cpu"))
    with pytest.raises(SystemExit):
        cs.require_gpu([])


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("four", [False, True])
def test_four_selects_only_its_phase(monkeypatch, four):
    cs = _load_chip_smoke()
    ran = []
    fake_dev = types.SimpleNamespace(platform="gpu", device_kind="X")
    monkeypatch.setattr(cs.jax, "devices", lambda *a: [fake_dev])
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "X, 700.00 W")
    monkeypatch.setattr(cs, "configure_compilation_cache", lambda: "")
    monkeypatch.setattr(cs.jax.config, "update", lambda *a: None)
    monkeypatch.setattr(
        cs, "run_phase", lambda name, *a, **k: ran.append(name) or True)
    assert cs.main(["--four"] if four else []) == 0
    if four:
        assert ran == ["device", "four"]
    else:
        assert "four" not in ran
        assert ran[:2] == ["device", "kernel"]
        assert {"solve_mg_300", "solve_mg_4096",
                "solve_reference_300"} <= set(ran)


def test_failed_phase_exits_nonzero(monkeypatch, capsys):
    cs = _load_chip_smoke()
    fake_dev = types.SimpleNamespace(platform="gpu", device_kind="X")
    monkeypatch.setattr(cs.jax, "devices", lambda *a: [fake_dev])
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "X, 700.00 W")
    monkeypatch.setattr(cs, "configure_compilation_cache", lambda: "")
    monkeypatch.setattr(cs.jax.config, "update", lambda *a: None)

    def boom(*a, **k):
        raise AssertionError("broken")

    monkeypatch.setattr(cs, "device_phase", boom)
    monkeypatch.setattr(cs, "four_phase", lambda card: {})
    assert cs.main(["--four"]) == 1
    out = capsys.readouterr().out
    assert '"device": {' not in out  # no contract line
    assert '{"phase": "device", "ok": false' in out


def test_unknown_device_kind_raises():
    from gmres_tpu.utils.profiling import HBM_PEAK_GBPS, hbm_peak_gbps

    with pytest.raises(KeyError, match="device_kind"):
        hbm_peak_gbps(jax.devices("cpu")[0])
    h100 = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert hbm_peak_gbps(h100) == HBM_PEAK_GBPS[h100.device_kind] == 3350.0


def _cache_rule(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from gmres_tpu.utils.cache import "
            "configure_compilation_cache as c; print(c()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_cache_dir_env_set_wins(tmp_path):
    chosen, configured = _cache_rule(str(tmp_path))
    assert chosen == configured == str(tmp_path)


def test_cache_dir_env_unset_uses_repo(tmp_path):
    chosen, configured = _cache_rule(None)
    assert chosen == configured == os.path.join(ROOT, ".jaxcache")


def test_kernel_phase_interpret_small():
    """The kernel phase's comparison and plan reporting, with the
    kernel in interpret mode at small widths (no timings on the CPU)."""
    cs = _load_chip_smoke()
    out = cs.kernel_phase("cpu", widths=(40, 16), interpret=True)
    assert [(r["n"], r["order"]) for r in out["rows"]] == [
        (40, 3), (40, 32), (16, 3), (16, 32)]
    for row in out["rows"]:
        assert row["rel_inf_err"] <= row["tol"]
        assert "kernel_s" not in row


def test_solve_phases_small_cpu():
    """Headline and reference solve phases at small sizes on the CPU:
    certified residuals, and the reference count equal to the plain
    baseline's in the same certify-true mode."""
    cs = _load_chip_smoke()
    head = cs.headline_solve(32, "cpu", repeats=1)
    assert head["status"] == 0 and head["true_rel_residual"] <= cs.TOL
    ref = cs.reference_solve(48, "cpu")
    assert abs(ref["total_inner"] - ref["baseline_inner"]) <= 1
