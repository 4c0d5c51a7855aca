"""DFT / FFT with the reference's conventions.

Reference: jwave/transforms/FastFourierTransform.java — Cooley-Tukey
radix-2 plus Bluestein chirp-z for arbitrary N, NumPy normalization
(forward unscaled, inverse 1/N, FastFourierTransform.java:205-211), and an
interleaved [re0, im0, re1, im1, ...] real-array API
(FastFourierTransform.java:55-103); jwave/transforms/
DiscreteFourierTransform.java:73-117 is the naive O(N^2) variant.

Design: ``jnp.fft`` is XLA-native for any N, so both radix-2 and chirp-z
collapse to one primitive. :func:`bluestein_fft` keeps the reference's
chirp-z algorithm for parity testing, and the naive DFT is kept as a dense
matmul.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .ndim import deinterleave, interleave


def fft(z, axis: int = -1):
    """Forward FFT on complex input (forward unscaled — NumPy convention)."""
    return jnp.fft.fft(jnp.asarray(z), axis=axis)


def ifft(z, axis: int = -1):
    """Inverse FFT on complex input (scaled by 1/N)."""
    return jnp.fft.ifft(jnp.asarray(z), axis=axis)


def fft_interleaved(x):
    """FFT on the reference's interleaved real format
    (FastFourierTransform.java:55-103): (..., 2N) -> (..., 2N)."""
    return interleave(fft(deinterleave(x)))


def ifft_interleaved(x):
    """Inverse of :func:`fft_interleaved`."""
    return interleave(ifft(deinterleave(x)))


def _bluestein_consts(n: int):
    """Host-side chirp constants for length-n Bluestein (chirp-z) DFT.

    The reference implements Bluestein in Java for arbitrary-N FFTs
    (FastFourierTransform.java:259-324). XLA's FFT covers arbitrary N
    itself, so :func:`fft` never routes here; this is the reference's
    algorithm, kept and tested for parity.
    """
    from ..utils.numerics import next_power_of_two

    idx = np.arange(n, dtype=np.float64)
    c = np.exp(-1j * np.pi * (idx * idx % (2 * n)) / n)  # e^{-i pi n^2 / N}
    l = next_power_of_two(2 * n - 1)
    v = np.zeros(l, dtype=np.complex128)
    chirp = np.conj(c)  # e^{+i pi m^2 / N}
    v[:n] = chirp
    v[l - n + 1 :] = chirp[1:][::-1]
    return c, np.fft.fft(v), l


def bluestein_fft(z, inverse: bool = False):
    """Arbitrary-length DFT along the last axis via pow-2 complex FFTs."""
    n = z.shape[-1]
    c, v_hat, l = _bluestein_consts(n)
    cdtype = jnp.complex128 if jnp.result_type(z) == jnp.complex128 else jnp.complex64
    z = z.astype(cdtype)
    cj = jnp.asarray(np.conj(c) if inverse else c, dtype=cdtype)
    vh = jnp.asarray(np.conj(v_hat) if inverse else v_hat, dtype=cdtype)
    u = z * cj
    pad = [(0, 0)] * (z.ndim - 1) + [(0, l - n)]
    conv = jnp.fft.ifft(jnp.fft.fft(jnp.pad(u, pad), axis=-1) * vh, axis=-1)[..., :n]
    out = conv * cj
    if inverse:
        out = out / n
    return out


def _dft_matrix(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def dft(z):
    """Naive O(N^2) DFT as a dense matmul (DiscreteFourierTransform.java:73-117).

    Kept for parity with the reference's DiscreteFourierTransform.
    """
    n = z.shape[-1]
    w = jnp.asarray(_dft_matrix(n, -1.0), dtype=jnp.result_type(z, np.complex64))
    return z @ w.T


def idft(z):
    """Inverse naive DFT (scaled by 1/N)."""
    n = z.shape[-1]
    w = jnp.asarray(_dft_matrix(n, +1.0), dtype=jnp.result_type(z, np.complex64))
    return (z @ w.T) / n


def dft_interleaved(x):
    """Naive DFT on interleaved real format (DiscreteFourierTransform.java:73-117)."""
    return interleave(dft(deinterleave(x)))


def idft_interleaved(x):
    """Inverse naive DFT on interleaved real format."""
    return interleave(idft(deinterleave(x)))
