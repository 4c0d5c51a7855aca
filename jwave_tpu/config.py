"""Precision and routing dials.

The reference computes in Java ``double`` everywhere. Correctness gates in
tests/ run in float64 on the CPU backend; chip_smoke.py recomputes the
float64 golden vectors on the GPU, which runs float64 natively, and runs
the main path in float32 at full width.
"""
from __future__ import annotations

import jax


def enable_x64(enabled: bool = True):
    """Enable float64 semantics process-wide (call before tracing)."""
    jax.config.update("jax_enable_x64", enabled)


def default_real_dtype():
    import jax.numpy as jnp

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_complex_dtype():
    import jax.numpy as jnp

    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


_CONV_PRECISION = "highest"


def set_conv_precision(name: str):
    """Precision of the library's f32 matmuls and convolutions, passed as
    ``lax.Precision``: 'highest' (true float32 — the default; the
    perfect-reconstruction claims hold), 'high' or 'default' (the backend
    may use faster reduced-precision arithmetic; on an NVIDIA GPU
    'default' permits TF32, about 1e-3 relative error). CPU is unaffected
    (always exact float32/float64)."""
    global _CONV_PRECISION
    if name not in ("default", "high", "highest"):
        raise ValueError(f"unknown precision {name!r}")
    _CONV_PRECISION = name


def conv_precision():
    import jax.lax as lax

    return {
        "default": lax.Precision.DEFAULT,
        "high": lax.Precision.HIGH,
        "highest": lax.Precision.HIGHEST,
    }[_CONV_PRECISION]


_MXU_DFT = "auto"


def set_mxu_dft(mode: str):
    """Route small fixed-length DFTs (Wigner-Ville lag transforms) through
    dense matmuls (ops.mxu_dft), and pick scattering's matmul/tile
    formulations: 'auto' (the default: scattering keeps its matmul
    formulations, the DFT consumers take the XLA FFT), 'on' (force the
    matmul DFT on any backend/dtype — tests use this on the f64 CPU
    backend), or 'off' (always the XLA FFT form)."""
    global _MXU_DFT
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown mxu_dft mode {mode!r}")
    _MXU_DFT = mode


def mxu_dft() -> str:
    return _MXU_DFT


_MXU_BUTTERFLY = "auto"


def set_mxu_butterfly(mode: str):
    """Route the FWT/WPT butterfly through banded tile matmuls
    (ops.mxu_butterfly, ops.mxu_wpt, ops.mxu_pyramid): 'on' (on any
    backend/dtype where the shape fits — tests use this on the f64 CPU
    backend); 'auto' (the default) and 'off' take the XLA conv form."""
    global _MXU_BUTTERFLY
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown mxu_butterfly mode {mode!r}")
    _MXU_BUTTERFLY = mode


def mxu_butterfly() -> str:
    return _MXU_BUTTERFLY
