"""Analytic-signal utilities (discrete Hilbert transform via FFT).

Companions to the time-frequency stack: the one-sided-spectrum analytic
signal, its envelope, and the phase-derivative instantaneous frequency —
the classical demodulation tools users reach for next to ssq_cwt/vmd
(e.g. to inspect a VMD mode's AM/FM content). One batched pow-2-capable
FFT round-trip each, any length; jit/vmap/grad-compatible.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..exceptions import JWaveFailure
from .fft import fft as _fft, ifft as _ifft


def analytic_signal(x):
    """One-sided-spectrum analytic signal of (..., N) real input.

    ``z = x + i H{x}`` via the standard discrete construction: double the
    positive-frequency bins, zero the negative ones (DC and Nyquist kept
    single). ``z.real`` equals the input exactly.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("analytic_signal - input must be real")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 2:
        raise JWaveFailure("analytic_signal - need at least 2 samples")
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    spec = _fft(x.astype(cdtype))
    gain = np.zeros(n)
    gain[0] = 1.0
    if n % 2 == 0:
        gain[1 : n // 2] = 2.0
        gain[n // 2] = 1.0
    else:
        gain[1 : (n + 1) // 2] = 2.0
    return _ifft(spec * jnp.asarray(gain, dtype=x.dtype))


def envelope(x):
    """Instantaneous amplitude |x + i H{x}| of (..., N) real input."""
    return jnp.abs(analytic_signal(x))


def instantaneous_frequency(x, sampling_rate: float = 1.0):
    """Phase-derivative instantaneous frequency (Hz) of (..., N) real input.

    Central differences of the unwrapped analytic phase, computed as
    ``angle(z[k+1] * conj(z[k-1])) / 2`` — the product form needs no
    explicit unwrapping and never sees a 2-pi jump unless the true
    per-step phase advance exceeds pi (i.e. frequency above Nyquist/2,
    where the sampling itself is ambiguous). Endpoints use one-sided
    differences. Returns (..., N).
    """
    z = analytic_signal(x)
    fwd = jnp.angle(z[..., 1:] * jnp.conj(z[..., :-1]))  # per-step advance
    mid = 0.5 * (fwd[..., 1:] + fwd[..., :-1])
    dphi = jnp.concatenate([fwd[..., :1], mid, fwd[..., -1:]], axis=-1)
    return dphi * (sampling_rate / (2.0 * np.pi))
