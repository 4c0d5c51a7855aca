"""chip_smoke.py on the CPU: its error helpers and references against small
oracle cases, every phase at tiny sizes, the exact result line, and its
refusal to run anywhere but on a GPU."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu.filters import get_filter

import oracle

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TINY = dict(batch=3, n=1 << 10, img=128, cwt_n=1 << 10, scales=6, ssq_batch=2)


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(cs, "REPS", 2)
    return {"seed": 0, "card": "cpu", "kind": "cpu", "prec": "test"}


@pytest.mark.parametrize("complex_", [False, True])
def test_rel_err_is_max_abs_over_max_ref(complex_, rng):
    ref = rng.standard_normal((4, 16))
    if complex_:
        ref = ref + 1j * rng.standard_normal((4, 16))
    got = ref.copy()
    got[2, 5] += 0.5
    assert cs.rel_err(got.astype(np.complex64 if complex_ else np.float32), ref) == pytest.approx(
        0.5 / np.max(np.abs(ref)), rel=1e-5)


@pytest.mark.parametrize("bad", ["shape", "nan"])
def test_rel_err_rejects_malformed_results(bad):
    ref = np.ones((2, 8))
    got = np.ones((2, 7)) if bad == "shape" else np.where(np.eye(2, 8) > 0, np.nan, 1.0)
    with pytest.raises(cs.PhaseFailure):
        cs.rel_err(got, ref)


def test_check_fails_above_tolerance():
    ref = np.linspace(1.0, 2.0, 32)
    assert cs.check("ok", ref * (1 + 1e-7), ref) <= cs.TOL
    with pytest.raises(cs.PhaseFailure):
        cs.check("off", ref * (1 + 1e-3), ref)


def test_check_abs_uses_absolute_error():
    ref = np.full(8, 1.0)
    assert cs.check_abs("ok", ref + 1e-13, ref, 1e-12) <= 1e-12
    with pytest.raises(cs.PhaseFailure):
        cs.check_abs("off", ref + 1e-9, ref, 1e-12)


def test_oracle_modwt_matches_library_f64(rng):
    x = rng.standard_normal((2, 96))
    ref = oracle.modwt(x, get_filter("db4"), 3)
    assert cs.rel_err(jw.modwt(jnp.asarray(x), "db4", 3), ref) < 1e-13


def test_fwt2d_reference_matches_library_f64(rng):
    img = rng.standard_normal((32, 64))
    ref = cs.fwt2d_reference(img, get_filter("db4"), 3)
    assert cs.rel_err(jw.fwt2d(jnp.asarray(img), "db4", 3, 3), ref) < 1e-13


def test_morlet_cwt_reference_matches_library_f64():
    sig = cs.chirp(512).astype(np.float64)
    scales = jw.generate_log_scales(1e-5, 1e-3, 5)
    ref = cs.morlet_cwt_reference(sig, scales, 1e6)
    got = jw.cwt(jnp.asarray(sig), scales=scales, wavelet=jw.MorletWavelet(1.0, 1.0),
                 sampling_rate=1e6).coefficients
    assert cs.rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("phase", ["modwt", "fwt", "fwt2d", "cwt", "ssq"])
def test_main_path_phase_tiny(phase, ctx, capsys):
    getattr(cs, f"phase_{phase}")(ctx, TINY)
    out = capsys.readouterr().out
    assert "FAIL" not in out and " ok" in out and "time " in out


def test_golden_phase_on_cpu(ctx, capsys):
    cs.phase_golden(ctx)
    out = capsys.readouterr().out
    assert out.count(" ok") == 17 and "FAIL" not in out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_is_exactly_the_contract(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev] * count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def _run(script: Path, cwd: Path, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_backend(tmp_path):
    r = _run(ROOT / "chip_smoke.py", ROOT, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_fails_without_the_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    r = _run(alone / "chip_smoke.py", alone, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
