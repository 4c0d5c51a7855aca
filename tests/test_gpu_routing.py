"""Routing as the GPU sees it, checked on the CPU with ``jax.default_backend``
reporting "gpu": every AUTO route takes the plain XLA form, no tile
formulation is chosen automatically, and the removed options stay
removed. Also the compile-cache helper, the mesh builder and the peak
table the GPU runs lean on."""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu.filters import get_filter
from jwave_tpu.utils import compile_cache

import oracle

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _forbid(monkeypatch, module, name):
    def boom(*a, **k):
        raise AssertionError(f"{module.__name__}.{name} must not be routed to")

    monkeypatch.setattr(module, name, boom)


@pytest.mark.parametrize("wavelet", ["Haar", "db4", "sym8"])
def test_modwt_auto_takes_fft_and_matches_oracle(wavelet, on_gpu, monkeypatch, rng):
    from jwave_tpu.ops import mxu_modwt

    _forbid(monkeypatch, mxu_modwt, "modwt_mxu")
    _forbid(monkeypatch, mxu_modwt, "imodwt_mxu")
    x = rng.standard_normal((2, 512))
    c = jw.modwt(jnp.asarray(x, jnp.float32), wavelet, 4)
    ref = oracle.modwt(x, get_filter(wavelet), 4)
    assert np.max(np.abs(np.asarray(c) - ref)) < 1e-5 * np.max(np.abs(ref))
    back = jw.imodwt(c, wavelet)
    assert np.max(np.abs(np.asarray(back) - x)) < 1e-5 * np.max(np.abs(x))


@pytest.mark.parametrize("n", [100, 257, 1000])
def test_fft_any_length_calls_jnp_fft(n, on_gpu, monkeypatch, rng):
    from jwave_tpu.ops import mxu_dft

    fft_mod = importlib.import_module("jwave_tpu.transforms.fft")  # the package re-exports fft()
    _forbid(monkeypatch, fft_mod, "bluestein_fft")
    _forbid(monkeypatch, mxu_dft, "dft")
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    np.testing.assert_allclose(np.asarray(jw.fft(jnp.asarray(z))), np.fft.fft(z), atol=1e-9)
    np.testing.assert_allclose(np.asarray(jw.ifft(jnp.asarray(z))), np.fft.ifft(z), atol=1e-12)


@pytest.mark.parametrize("gate", ["butterfly", "wpt", "pyramid", "dft"])
def test_auto_tile_gates_never_choose_tiles(gate, on_gpu):
    from jwave_tpu.ops import mxu_butterfly, mxu_dft, mxu_pyramid, mxu_wpt

    x = jnp.zeros((4, 1024), jnp.float32)  # f32, lane-aligned: every shape gate passes
    assert jw.config.mxu_butterfly() == "auto" and jw.config.mxu_dft() == "auto"
    chosen = {
        "butterfly": lambda: mxu_butterfly.mxu_butterfly_eligible(x),
        "wpt": lambda: mxu_wpt.mxu_wpt_eligible(x, 3),
        "pyramid": lambda: mxu_pyramid.pyramid_eligible(x),
        "dft": mxu_dft.eligible,
    }[gate]()
    assert chosen is False


def test_ssq_auto_reassign_is_the_measured_winner(on_gpu, rng):
    from jwave_tpu.transforms.ssq import AUTO_REASSIGN

    assert AUTO_REASSIGN == "scatter"
    x = jnp.asarray(np.cos(2 * np.pi * 50.0 * np.arange(512) / 1000.0))
    scales = jw.generate_log_scales(0.002, 0.2, 16)
    auto = jw.ssq_cwt(x, scales, "morlet", 1000.0).Tx
    scatter = jw.ssq_cwt(x, scales, "morlet", 1000.0, reassign="scatter").Tx
    np.testing.assert_array_equal(np.asarray(auto), np.asarray(scatter))


def test_ssq_reassign_pallas_is_gone():
    x = jnp.zeros(256)
    with pytest.raises(jw.JWaveFailure):
        jw.ssq_cwt(x, jw.generate_log_scales(0.01, 0.1, 4), "morlet", 100.0, reassign="pallas")


def test_convolution_method_has_no_pallas():
    assert not hasattr(jw.ConvolutionMethod, "PALLAS")
    assert {m.name for m in jw.ConvolutionMethod} == {"AUTO", "DIRECT", "FFT", "MXU"}


def test_median_abs_default_is_the_sort_median(on_gpu, monkeypatch, rng):
    from jwave_tpu.utils import select

    _forbid(monkeypatch, select, "median_nonneg")
    a = jnp.asarray(rng.standard_normal((3, 41)))
    np.testing.assert_array_equal(np.asarray(select.median_abs(a)),
                                  np.median(np.abs(np.asarray(a)), axis=-1))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.compile_cache_dir() == tmp_path / "c"
    seen = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.append((k, v)))
    assert compile_cache.enable_compile_cache() == tmp_path / "c"
    assert (tmp_path / "c").is_dir()
    assert seen == [("jax_compilation_cache_dir", str(tmp_path / "c"))]


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.compile_cache_dir()
    assert first == compile_cache.compile_cache_dir() == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_make_mesh_refuses_more_devices_than_exist():
    from jwave_tpu.parallel import make_mesh

    assert make_mesh((4,), ("t",)).devices.size == 4
    with pytest.raises(jw.JWaveFailure):
        make_mesh((len(jax.devices()) + 1,), ("t",))


def _roofline():
    spec = importlib.util.spec_from_file_location("roofline", ROOT / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peak_table_has_the_h100():
    peaks = _roofline().device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_Bps"] == 3.35e12 and peaks["fp32_flops"] == 67e12 and peaks["tf32_flops"] == 495e12


def test_peak_table_rejects_unknown_kind():
    with pytest.raises(KeyError):
        _roofline().device_peaks("Unknown Accelerator X1")
